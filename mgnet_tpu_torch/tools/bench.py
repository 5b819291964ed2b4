"""Benchmark of the port's fused joint panoptic + depth frame.

    python -m mgnet_tpu_torch.tools.bench [--breakdown] [--repeat N]
        [--device cuda] [--height 1024] [--width 2048]

The counterpart of ``bench.py``: the default config (ResNet-18, 20
classes, bf16) with ``IGNORED_CATEGORIES_IN_DEPTH = ["ego vehicle",
"sky"]``, weights drawn from seed 0, the seed-0 image and the Cityscapes
camera of ``bench.py``, at batch 1 on ``--device``.

The protocol is chained dependencies: each frame's input is ``image +
carry * 1e-24``, where the carry is the nansum of every output of the
frame before, so that no two frames overlap and no output can be left
uncomputed; 10 warmup frames, then 50 timed on the host clock, and the
final carry read to the host (``.item()``) proves that the chain ran.
The last line of standard output is one JSON object: ``metric``
(``joint_panoptic_depth_inference_fps_<H>x<W>``), ``value`` (fps),
``unit``, ``vs_baseline`` (fps / 30); with ``--repeat N`` also ``std``
and ``runs``: N fresh processes, mean and sample standard deviation.
``--breakdown`` times the stages with the same protocol (30 frames each)
on standard error: ``model_forward``, ``panoptic_fusion_kernel`` (with
the ``center_argmin`` kernel), ``panoptic_fusion_plain`` (with
``center_argmin_reference``), ``dgc_scaling`` and ``full_fused``. An
earlier line of standard error names the device: on a card, its name and
power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from functools import partial
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.data import (
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    Metadata,
    build_meta,
)
from mgnet_tpu_torch.geometry import Camera
from mgnet_tpu_torch.geometry.depth import inv2depth
from mgnet_tpu_torch.geometry.image import (
    interpolate_bilinear,
    interpolate_bilinear_cf,
)
from mgnet_tpu_torch.inference import (
    build_fused_inference,
    fusion_kwargs,
    statics_from_meta,
)
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.ops.center_argmin import (
    center_argmin,
    center_argmin_reference,
)
from mgnet_tpu_torch.postprocessing.depth import dgc_scale_factor
from mgnet_tpu_torch.postprocessing.panoptic import panoptic_fusion
from mgnet_tpu_torch.train.step import normalize_images

__all__ = ["build_pipeline", "chained_seconds_per_iter", "main"]

BASELINE_FPS = 30.0
WARMUP, ITERS, STAGE_ITERS = 10, 50, 30


def chained_seconds_per_iter(step_fn, iters: int, device,
                             warmup: int = WARMUP) -> float:
    """Host seconds per call of ``step_fn(carry) -> carry`` (f32 scalars
    on ``device``) over a chain of ``iters`` calls after ``warmup``; the
    final carry is read to the host and must be finite."""
    carry = torch.zeros((), device=device)
    for _ in range(warmup):
        carry = step_fn(carry)
    carry.item()
    carry = torch.zeros((), device=device)
    t0 = time.perf_counter()
    for _ in range(iters):
        carry = step_fn(carry)
    final = carry.item()
    dt = time.perf_counter() - t0
    if not math.isfinite(final):
        raise RuntimeError(f"the benchmark's chain ended in {final}")
    return dt / iters


def build_pipeline(height: int = 1024, width: int = 2048, device="cuda"):
    """(cfg, model, statics, fused frame, image [1,H,W,3] f32, K [1,3,3],
    camera height [1]), all on ``device``."""
    cfg = get_default_config()
    cfg.INPUT.IGNORED_CATEGORIES_IN_DEPTH = ["ego vehicle", "sky"]
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    model.to(device)
    meta = Metadata(name="bench").set(
        **build_meta(CITYSCAPES_SCENE_SEG_CATEGORIES))
    statics = statics_from_meta(cfg, meta)
    fused = build_fused_inference(
        model, statics, tuple(cfg.MODEL.PIXEL_MEAN),
        tuple(cfg.MODEL.PIXEL_STD), device=device)
    image = torch.as_tensor(
        np.random.RandomState(0).randint(0, 255, (1, height, width, 3)),
        dtype=torch.float32, device=device)
    K = torch.tensor([[[2262.52, 0, 1096.98],
                       [0, 2265.30, 513.137],
                       [0, 0, 1]]], device=device)
    cam_h = torch.tensor([1.22], device=device)
    return cfg, model, statics, fused, image, K, cam_h


def _breakdown(pipeline, device, full_sec: float):
    """Seconds per call of each stage, in the chained protocol."""
    cfg, model, s, _, image, K, cam_h = pipeline
    pm, ps = tuple(cfg.MODEL.PIXEL_MEAN), tuple(cfg.MODEL.PIXEL_STD)

    def model_step(carry):
        out = model(normalize_images(image + carry * 1e-24, pm, ps))
        return sum(out[k].float().sum()
                   for k in ("sem_seg", "center", "offset", "depth"))

    # the heads' outputs as the frame post-processes them, fixed
    out = model(normalize_images(image, pm, ps))
    stride = model.common_stride
    hw = (out["sem_seg"].shape[1] * stride, out["sem_seg"].shape[2] * stride)
    sem = torch.argmax(interpolate_bilinear_cf(
        out["sem_seg"].permute(0, 3, 1, 2).float(), hw), dim=1).int()
    center = interpolate_bilinear(out["center"].float(), hw)[..., 0]
    offset = interpolate_bilinear(out["offset"].float(), hw) * float(stride)
    depth = inv2depth(interpolate_bilinear(out["inv_depth"], hw)).float()

    def fusion_step(argmin):
        fuse = partial(panoptic_fusion, **fusion_kwargs(s), argmin=argmin)
        return lambda carry: fuse(sem, center + carry * 1e-24,
                                  offset).float().sum()

    def dgc_step(carry):
        points = Camera(K).reconstruct(depth + carry * 1e-24, frame="c")
        return dgc_scale_factor(points, cam_h, None).sum()

    run = partial(chained_seconds_per_iter, iters=STAGE_ITERS, device=device)
    return {
        "model_forward": run(model_step),
        "panoptic_fusion_kernel": run(fusion_step(center_argmin)),
        "panoptic_fusion_plain": run(fusion_step(center_argmin_reference)),
        "dgc_scaling": run(dgc_step),
        "full_fused": full_sec,
    }


def _device_line(device) -> str:
    if torch.device(device).type != "cuda":
        return f"# device: {device} (no card)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return (f"# device: {torch.cuda.get_device_name(device)}; "
            f"nvidia-smi: {smi}")


def _record(metric: str, fps: float) -> dict:
    return {"metric": metric, "value": round(fps, 3), "unit": "fps",
            "vs_baseline": round(fps / BASELINE_FPS, 4)}


def _repeat(argv: List[str], n: int) -> dict:
    """``n`` fresh processes of this benchmark with ``argv``: their fps,
    mean and sample standard deviation."""
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    vals, metric = [], None
    for i in range(n):
        res = subprocess.run(
            [sys.executable, "-m", "mgnet_tpu_torch.tools.bench", *argv],
            capture_output=True, text=True, timeout=1800, env=env)
        if res.returncode != 0:
            raise RuntimeError(f"bench run {i + 1}/{n} failed (rc "
                               f"{res.returncode}):\n{res.stderr[-4000:]}")
        sys.stderr.write(res.stderr)
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        vals.append(rec["value"])
        metric = rec["metric"]
        print(f"# run {i + 1}/{n}: {rec['value']} fps", file=sys.stderr)
    mean = float(np.mean(vals))
    std = float(np.std(vals, ddof=1)) if n > 1 else 0.0
    print(f"# {metric}: {mean:.3f} ± {std:.3f} fps over {n} runs",
          file=sys.stderr)
    return {**_record(metric, mean), "std": round(std, 3),
            "runs": [round(v, 3) for v in vals]}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--breakdown", action="store_true")
    p.add_argument("--repeat", type=int, default=0,
                   help="run N fresh processes and report mean ± σ")
    p.add_argument("--device", default="cuda")
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=2048)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the benchmark as the command line says; print and return the
    JSON record."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.repeat:
        i = argv.index("--repeat")
        rec = _repeat(argv[:i] + argv[i + 2:], args.repeat)
    else:
        print(_device_line(args.device), file=sys.stderr, flush=True)
        metric = (f"joint_panoptic_depth_inference_fps_"
                  f"{args.height}x{args.width}")
        with torch.inference_mode():
            pipeline = build_pipeline(args.height, args.width, args.device)
            fused, image, K, cam_h = pipeline[3:]

            def full_step(carry):
                out = fused(image + carry * 1e-24, camera_matrix=K,
                            camera_height=cam_h)
                # nansum: the point cloud is NaN on sky and ego pixels
                return sum(torch.nansum(v.float()) for v in out.values())

            sec = chained_seconds_per_iter(full_step, ITERS, args.device)
            if args.breakdown:
                for k, v in _breakdown(pipeline, args.device, sec).items():
                    print(f"# {k}: {v * 1e3:.3f} ms  ({1.0 / v:.1f} /s)",
                          file=sys.stderr)
        rec = _record(metric, 1.0 / sec)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
