#!/usr/bin/env python3
"""The bf16 probe (``tools/probe_torch_bf16_export.py``) on chip_smoke.py's
own ``model_final``, where the bfloat16 package misses ``BARS[bfloat16]``.

    python3 tools/probe_torch_bf16_model_final.py [probe flags ...]

Card only. Runs chip_smoke.py's device, build, trainer and eval phases in
a temporary directory (the 1024x2048 tree, 4 Fine iterations at batch 12
and the resume with evaluation: about two minutes on an H100), then the
probe with ``--weights`` on that ``model_final`` at 256x512 and any
further flags given, in a subprocess. Exits with the probe's code.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    t0 = time.perf_counter()
    _, _, smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    with tempfile.TemporaryDirectory(prefix="mgnet_probe_") as tmp:
        chip_smoke.phase_trainer(smi, Path(tmp))
        chip_smoke.phase_eval(smi, Path(tmp))
        print(f"[probe] model_final ready in {time.perf_counter() - t0:.1f}"
              " s", flush=True)
        rc = subprocess.run([
            sys.executable, str(ROOT / "tools" / "probe_torch_bf16_export.py"),
            "--weights", str(Path(tmp) / "out" / "model_final"),
            "--height", "256", "--width", "512",
            *(sys.argv[1:] if argv is None else argv)]).returncode
    print(f"[probe] rc {rc}, {time.perf_counter() - t0:.1f} s; {smi}",
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
