"""The fused frame's time by pipeline stage, beside each stage's
matrix-FLOP floor on the card.

    python -m mgnet_tpu_torch.tools.profile_fused_roofline [--height 1024]
        [--width 2048] [--iters 40] [--trace DIR] [--device cuda]

The counterpart of ``tools/profile_fused_roofline.py``, by the same
telescoping structural ablation of ``tools.bench``'s frame (bf16, seeded
weights, the seed-0 image and camera): each variant removes one more
trailing stage,

  V0 full                            the frame as served
  V1 -DGC/points                     no DGC rescale, no point cloud
  V2 -depth branch                   panoptic only: the depth decoder and
                                     head are not run (the model's
                                     ``with_depth`` off for the call)
  V3 -panoptic fusion                heads upsampled + argmax, no fusion
  V4 -upsample/argmax (raw heads)    the stride-8 semantic and instance
                                     heads

and each ledger row is T(i) - T(i+1), the last V4 itself, so the rows sum
to the measured frame. Times: host clock around ``--iters`` frames after
5 warmup, the card synchronised at both ends. Each row's floor is its
matrix FLOPs (convolutions and matrix products, ``FlopCounterMode`` on
one call of each variant; the elementwise work and ``center_argmin`` are
not counted) over the H100's dense bf16 peak, 989 TFLOP/s
(``utils.profiling.PEAK_BF16_FLOPS``); no count of a row's bytes is
honest here, so none is printed.
``center_argmin``'s launches per frame are counted for each variant.
``--trace DIR`` captures one full frame with ``torch.profiler``. The last
line is one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import List, Optional

import torch

from mgnet_tpu_torch.geometry.image import (
    interpolate_bilinear,
    interpolate_bilinear_cf,
)
from mgnet_tpu_torch.inference import build_fused_inference
from mgnet_tpu_torch.ops.center_argmin import center_argmin
from mgnet_tpu_torch.tools.bench import build_pipeline
from mgnet_tpu_torch.train.step import normalize_images
from mgnet_tpu_torch.utils.profiling import (
    PEAK_BF16_FLOPS,
    count_flops,
    device_line,
    host_ms,
    require_device,
    trace,
)

__all__ = ["build_variants", "main", "parse_args"]


@contextlib.contextmanager
def _without_depth(model):
    """The model's depth branch off for the block."""
    saved = model.with_depth
    model.with_depth = False
    try:
        yield
    finally:
        model.with_depth = saved


def build_variants(height: int, width: int, device) -> dict:
    """Ordered {name: call} variants, each removing one more trailing
    stage of the frame."""
    cfg, model, statics, fused, image, K, cam_h = build_pipeline(
        height, width, device)
    pm, ps = tuple(cfg.MODEL.PIXEL_MEAN), tuple(cfg.MODEL.PIXEL_STD)
    no_dgc = statics._replace(use_dgc=False)
    f_nodgc = build_fused_inference(model, no_dgc, pm, ps,
                                    return_point_cloud=False, device=device)
    f_pan = build_fused_inference(model, no_dgc, pm, ps, with_depth=False,
                                  return_point_cloud=False, device=device)

    def raw_heads():
        out = model(normalize_images(image, pm, ps))
        return {k: out[k] for k in ("sem_seg", "center", "offset")}

    def heads_upsampled():
        out = raw_heads()
        stride = model.common_stride
        hw = (out["sem_seg"].shape[1] * stride,
              out["sem_seg"].shape[2] * stride)
        sem_cf = interpolate_bilinear_cf(
            out["sem_seg"].permute(0, 3, 1, 2).float(), hw)
        return {"sem_seg": torch.argmax(sem_cf, dim=1).int(),
                "center": interpolate_bilinear(out["center"].float(),
                                               hw)[..., 0],
                "offset": interpolate_bilinear(out["offset"].float(), hw)
                * float(stride)}

    def without_depth(fn):
        def call():
            with _without_depth(model):
                return fn()
        return call

    return {
        "V0 full": lambda: fused(image, K, cam_h),
        "V1 -DGC/points": lambda: f_nodgc(image, K, cam_h),
        "V2 -depth branch": without_depth(lambda: f_pan(image)),
        "V3 -panoptic fusion": without_depth(heads_upsampled),
        "V4 -upsample/argmax (raw heads)": without_depth(raw_heads),
    }


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--iters", type=int, default=40)
    p.add_argument("--trace", default="")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    device = require_device(args.device)
    print(device_line(device), file=sys.stderr)
    runs = []
    with torch.inference_mode():
        variants = build_variants(args.height, args.width, device)
        for name, fn in variants.items():
            before = center_argmin.launches
            t = host_ms(fn, args.iters, warmup=5, device=device)
            launches = (center_argmin.launches - before) / (args.iters + 5)
            fl = count_flops(fn)
            runs.append((name, t, fl, launches))
            print(f"# {name}: {t:.3f} ms, {fl / 1e9:.1f} GFLOP (matrix), "
                  f"center_argmin launches/frame {launches:g}",
                  file=sys.stderr, flush=True)
        with trace(args.trace):
            variants["V0 full"]()
    print(f"# {'stage (telescoping delta)':40s} {'ms':>8s} {'GFLOP':>7s} "
          f"{'floor ms':>9s} {'x floor':>8s}", file=sys.stderr)
    rows = []
    for i, (name, t, fl, _) in enumerate(runs):
        nt, nfl = (runs[i + 1][1:3] if i + 1 < len(runs) else (0.0, 0))
        dt, dfl = t - nt, fl - nfl
        stage = name if i + 1 == len(runs) else f"{name} minus " \
            f"{runs[i + 1][0]}"
        floor = dfl / PEAK_BF16_FLOPS * 1e3
        over = dt / floor if floor > 0 else None
        rows.append({"stage": stage, "ms": round(dt, 4),
                     "gflop": round(dfl / 1e9, 2),
                     "floor_ms": round(floor, 4),
                     "x_over_floor": None if over is None else round(over, 1)})
        print(f"# {stage[:40]:40s} {dt:8.3f} {dfl / 1e9:7.1f} {floor:9.4f} "
              f"{'-' if over is None else f'{over:.1f}':>8s}",
              file=sys.stderr)
    print(f"# {'FULL FRAME (sum of rows)':40s} {runs[0][1]:8.3f}",
          file=sys.stderr)
    out = {"metric": "fused_frame_stage_roofline",
           "full_ms": round(runs[0][1], 4), "rows": rows,
           "ledger_sum_ms": round(sum(r["ms"] for r in rows), 4),
           "center_argmin_launches_per_frame": {r[0]: r[3] for r in runs},
           "peak_tflops": PEAK_BF16_FLOPS / 1e12,
           "device": str(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
