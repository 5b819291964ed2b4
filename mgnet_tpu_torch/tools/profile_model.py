"""The port's model forward by stage at the inference resolution, on the
card.

    python -m mgnet_tpu_torch.tools.profile_model [--h 1024] [--w 2048]
        [--iters 30] [--trace DIR] [--device cuda] [KEY VALUE ...]

The counterpart of ``tools/profile_model.py``: the default config's
eval model (bf16, weights drawn from seed 0) on the seeded image at
batch 1; stages: the backbone with the GCM, the whole forward at stride 8
(no upsample), the whole forward upsampled, the upsample tail alone (the
four stride-8 head outputs to full size), the 20-class semantic upsample
alone, and that upsample with its argmax. Each stage is timed on the host
clock around ``--iters`` calls after 5 warmup, the card synchronised at
both ends. ``--trace DIR`` captures one upsampled forward with
``torch.profiler``. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.geometry.image import interpolate_bilinear
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.train.step import normalize_images
from mgnet_tpu_torch.utils.profiling import (
    device_line,
    host_ms,
    require_device,
    trace,
)

__all__ = ["main", "parse_args"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--h", type=int, default=1024)
    p.add_argument("--w", type=int, default=2048)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--trace", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="config overrides (KEY VALUE ...)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    device = require_device(args.device)
    h, w = args.h, args.w
    cfg = get_default_config()
    cfg.merge_from_list(list(args.opts))
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    model.to(device).eval()
    image = torch.as_tensor(
        np.random.RandomState(0).randint(0, 255, (1, h, w, 3)),
        dtype=torch.float32, device=device)
    results = {}
    with torch.inference_mode():
        x = normalize_images(image, tuple(cfg.MODEL.PIXEL_MEAN),
                             tuple(cfg.MODEL.PIXEL_STD))
        nchw = x.permute(0, 3, 1, 2)
        out8 = model(x)

        def features():
            with model._autocast(device.type):
                return model._features(nchw)

        def tail():
            return [interpolate_bilinear(out8[k].float(), (h, w))
                    for k in ("sem_seg", "center", "offset", "inv_depth")]

        def sem_argmax():
            up = interpolate_bilinear(out8["sem_seg"].float(), (h, w))
            return torch.argmax(up.permute(0, 3, 1, 2), dim=1)

        calls = {
            "backbone+gcm": features,
            "forward_stride8 (no upsample)": lambda: model(x),
            "forward_full (upsampled)": lambda: model(x, upsample=True),
            "upsample_tail (4 heads)": tail,
            "upsample_sem20 only": lambda: interpolate_bilinear(
                out8["sem_seg"].float(), (h, w)),
            "upsample_sem20+argmax": sem_argmax,
        }
        for name, fn in calls.items():
            results[name] = host_ms(fn, args.iters, warmup=5, device=device)
        with trace(args.trace):
            model(x, upsample=True)
    print(device_line(device))
    print(f"{h}x{w}  dtype={model.dtype}")
    for name, ms in results.items():
        print(f"{name:>32s}: {ms:8.3f} ms")
    out = {"metric": "model_stage_ms", "hw": [h, w],
           "stages_ms": {k: round(v, 4) for k, v in results.items()},
           "device": str(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
