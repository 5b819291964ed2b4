"""The fused inference frame's latency by stage, on the card.

    python -m mgnet_tpu_torch.tools.profile_inference [--height 1024]
        [--width 2048] [--iters 30] [--tta] [--tta-batch 2]
        [--trace DIR] [--device cuda]

The counterpart of ``tools/profile_inference.py``, on the frame of
``tools.bench`` (the default config in bf16, weights from seed 0, the
seed-0 image and its Cityscapes camera): the launch overhead (one tiny
op), the model forward with the heads upsampled (``make_eval_step``) and
without, the panoptic fusion alone (zero heads), the DGC scale alone
(seeded points and ground mask), and the whole fused frame. Each is
timed on the host clock around ``--iters`` calls after 5 warmup, the card
synchronised at both ends; ``center_argmin``'s launches per call are
counted where the stage clusters (one per frame).

``--tta`` instead times the multi-scale + flip step of the pseudo-label
tool (``inference.tta``, 7 scales x 2 flips, softmax-averaged classes,
argmax and the batched panoptic fusion) on ``--tta-batch`` seeded images,
per step and per image. ``--trace DIR`` captures one frame (or TTA step)
with ``torch.profiler``. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from mgnet_tpu_torch.inference import fusion_kwargs
from mgnet_tpu_torch.inference.tta import multi_scale_flip_inference
from mgnet_tpu_torch.ops.center_argmin import center_argmin
from mgnet_tpu_torch.postprocessing.depth import dgc_scale_factor
from mgnet_tpu_torch.postprocessing.panoptic import panoptic_fusion
from mgnet_tpu_torch.tools.bench import build_pipeline
from mgnet_tpu_torch.train.step import make_eval_step, normalize_images
from mgnet_tpu_torch.utils.profiling import (
    device_line,
    host_ms,
    require_device,
    trace,
)

__all__ = ["main", "parse_args"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--tta", action="store_true",
                   help="time the MSC + flip TTA step instead")
    p.add_argument("--tta-batch", type=int, default=2)
    p.add_argument("--trace", default="")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _timed(fn, iters: int, device, clusters: bool):
    """(ms per call, center_argmin launches per call or None)."""
    before = center_argmin.launches
    ms = host_ms(fn, iters, warmup=5, device=device)
    n = (center_argmin.launches - before) / (iters + 5)
    return ms, (n if clusters else None)


def _tta(args, pipeline, device) -> dict:
    cfg, model, statics = pipeline[:3]
    b, h, w = args.tta_batch, args.height, args.width
    images = torch.as_tensor(
        np.random.RandomState(0).randint(0, 255, (b, h, w, 3)),
        dtype=torch.float32, device=device)
    pm, ps = tuple(cfg.MODEL.PIXEL_MEAN), tuple(cfg.MODEL.PIXEL_STD)

    def step():
        out = multi_scale_flip_inference(
            model, normalize_images(images, pm, ps), with_panoptic=True,
            with_depth=False)
        sem = torch.argmax(out["sem_seg"], dim=-1).int()
        return panoptic_fusion(sem, out["center"][..., 0], out["offset"],
                               **fusion_kwargs(statics))

    ms, launches = _timed(step, args.iters, device, True)
    with trace(args.trace):
        step()
    print(f"TTA MSC+flip batch {b} @ {h}x{w}: {ms:.1f} ms/step = "
          f"{ms / b:.1f} ms/img ({b / ms * 1e3:.2f} img/s); center_argmin "
          f"launches/step {launches:g}")
    return {"metric": "tta_step_ms", "value": round(ms, 3),
            "ms_per_image": round(ms / b, 3), "batch": b, "hw": [h, w],
            "center_argmin_launches_per_step": launches}


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    device = require_device(args.device)
    h, w = args.height, args.width
    print(device_line(device))
    with torch.inference_mode():
        pipeline = build_pipeline(h, w, device)
        cfg, model, statics, fused, image, K, cam_h = pipeline
        if args.tta:
            out = _tta(args, pipeline, device)
        else:
            eval_step = make_eval_step(cfg)
            x = normalize_images(image, tuple(cfg.MODEL.PIXEL_MEAN),
                                 tuple(cfg.MODEL.PIXEL_STD))
            tiny = torch.zeros(8, 128, device=device)
            zeros = (torch.zeros(1, h, w, dtype=torch.int32, device=device),
                     torch.zeros(1, h, w, device=device),
                     torch.zeros(1, h, w, 2, device=device))
            gen = torch.Generator().manual_seed(1)
            pts = torch.randn(1, h, w, 3, generator=gen).to(device)
            mask = (torch.rand(1, h, w, generator=gen) > 0.7).to(device)
            calls = {
                "dispatch overhead (one tiny op)": (lambda: tiny + 1.0,
                                                    False),
                "model forward (heads upsampled)": (
                    lambda: eval_step(model, image), False),
                "model forward (no upsample)": (lambda: model(x), False),
                "panoptic fusion": (lambda: panoptic_fusion(
                    *zeros, **fusion_kwargs(statics)), True),
                "DGC scale (normals+median)": (lambda: dgc_scale_factor(
                    pts, cam_h, mask), False),
                "full fused pipeline": (lambda: fused(image, K, cam_h),
                                        True),
            }
            stages, launches = {}, {}
            for name, (fn, clusters) in calls.items():
                ms, n = _timed(fn, args.iters, device, clusters)
                stages[name] = round(ms, 4)
                if n is not None:
                    launches[name] = n
                print(f"{name:40s} {ms:8.2f} ms  ({1e3 / ms:7.1f} fps)"
                      + (f"  center_argmin launches/call {n:g}"
                         if n is not None else ""))
            with trace(args.trace):
                fused(image, K, cam_h)
            out = {"metric": "fused_frame_stage_ms", "hw": [h, w],
                   "stages_ms": stages,
                   "center_argmin_launches_per_call": launches}
    out["device"] = str(device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
