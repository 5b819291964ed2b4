"""The port imports as it must on the card's machine, which has PyTorch,
numpy, scipy and einops but no JAX, flax, optax, orbax, PyYAML, Pillow or
OpenCV, and where the JAX package is not to be used.

A subprocess installs a ``sys.meta_path`` finder that refuses those
modules and ``mgnet_tpu``, then imports every module of
``mgnet_tpu_torch`` (the bench, profile and runbook tools among them),
``chip_smoke`` and the port's card probes in ``tools/``. ``chip_smoke.py`` must also refuse
to run without a card: non-zero exit and no result line.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REFUSED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "PIL", "cv2",
           "mgnet_tpu")
# the port's scripts under tools/, run as modules that are not __main__
SCRIPTS = ("tools/probe_torch_bf16_export.py",
           "tools/probe_torch_bf16_model_final.py")

_CHILD = r"""
import importlib, importlib.abc, pkgutil, runpy, sys
REFUSED = set(sys.argv[1].split(","))

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import mgnet_tpu_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    mgnet_tpu_torch.__path__, "mgnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for path in sys.argv[2:]:
    runpy.run_path(path, run_name="isolated")
    names.append(path)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print("IMPORTED", len(names))
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra)
    return env


def test_port_imports_without_jax_and_host_packages():
    res = subprocess.run(
        [sys.executable, "-c", _CHILD, ",".join(REFUSED), *SCRIPTS], cwd=ROOT,
        env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    n = int(res.stdout.split("IMPORTED")[1])
    assert n >= 20, res.stdout


def test_chip_smoke_refuses_to_run_without_a_card():
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT,
        env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
