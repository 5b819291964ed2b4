"""The port's post-processing by stage, on the card.

    python -m mgnet_tpu_torch.tools.profile_postproc [--h 1024] [--w 2048]
        [--iters 30] [--k 128] [--trace DIR] [--device cuda]

The counterpart of ``tools/profile_postproc.py``, on its seeded inputs
(classes 0-19, a uniform center heatmap, offsets of 10 pixels' spread,
points and a ground mask for DGC) at batch 1: the center NMS (max pool
7), NMS + top-K centers, the clustering through the ``center_argmin``
kernel and through its plain version, the class vote (``vote_counts``),
the stuff-area counts, the 20-class argmax of seeded logits, the whole
panoptic fusion, the surface normals, the masked median and the whole
DGC scale. Each
stage is timed on the host clock around ``--iters`` calls after 5
warmup, the card synchronised at both ends; the ``center_argmin``
kernel's launches per call are counted for the stages that cluster (one
per frame). ``--trace DIR`` captures one fusion and one DGC with
``torch.profiler``. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mgnet_tpu_torch.ops.center_argmin import (
    center_argmin,
    center_argmin_reference,
)
from mgnet_tpu_torch.postprocessing.depth import (
    _masked_median,
    dgc_scale_factor,
    surface_normals,
)
from mgnet_tpu_torch.postprocessing.panoptic import (
    _cluster_pixels,
    find_instance_centers,
    panoptic_fusion,
    vote_counts,
)
from mgnet_tpu_torch.utils.profiling import (
    device_line,
    host_ms,
    require_device,
    trace,
)

__all__ = ["main", "parse_args", "postproc_inputs", "stages"]


def postproc_inputs(h: int, w: int, device):
    """The JAX tool's seeded inputs, at batch 1 on ``device``."""
    rng = np.random.RandomState(0)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=device)

    sem = t(rng.randint(0, 20, (1, h, w)), torch.int32)
    center = t(rng.rand(1, h, w))
    offsets = t(rng.randn(1, h, w, 2) * 10)
    points = t(rng.rand(1, h, w, 3) * 50 + 0.5)
    mask = t(rng.rand(1, h, w) > 0.5, torch.bool)
    return sem, center, offsets, points, mask


def stages(h: int, w: int, k: int, device) -> dict:
    """name -> (call, whether it launches center_argmin)."""
    sem, center, offsets, points, mask = postproc_inputs(h, w, device)
    heights = points[..., 1].abs()
    logits = torch.randn(1, 20, h, w, generator=torch.Generator()
                         .manual_seed(0)).to(device)
    cam_h = torch.tensor([1.22], device=device)
    thing = sem > 11
    with torch.inference_mode():
        centers0, valid0, _ = find_instance_centers(center, 0.3, 7, k)
        cluster0 = _cluster_pixels(centers0, valid0, offsets, thing,
                                   center_argmin_reference).long()

    def nms():
        x = torch.where(center > 0.3, center, -1.0)
        return F.max_pool2d(x[:, None], 7, stride=1, padding=3)

    def fusion():
        return panoptic_fusion(sem, center, offsets, num_classes=20,
                               last_stuff_id=11, max_instances=k)

    return {
        "nms_maxpool7": (nms, False),
        "nms+topk": (lambda: find_instance_centers(center, 0.3, 7, k),
                     False),
        "cluster_kernel": (lambda: _cluster_pixels(
            centers0, valid0, offsets, thing, center_argmin), True),
        "cluster_plain": (lambda: _cluster_pixels(
            centers0, valid0, offsets, thing, center_argmin_reference),
                          False),
        "vote_counts": (lambda: vote_counts(cluster0, sem.long(), k + 1, 20),
                        False),
        "stuff_counts": (lambda: torch.bincount(
            torch.where((sem >= 0) & (sem <= 11), sem, 12).reshape(-1).long(),
            minlength=13), False),
        "sem_argmax20": (lambda: torch.argmax(logits, dim=1), False),
        "fusion_full": (fusion, True),
        "surface_normals": (lambda: surface_normals(points), False),
        "masked_median": (lambda: _masked_median(heights, mask), False),
        "dgc_full": (lambda: dgc_scale_factor(points, cam_h, mask), False),
    }


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--h", type=int, default=1024)
    p.add_argument("--w", type=int, default=2048)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--trace", default="")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    device = require_device(args.device)
    print(device_line(device))
    results, launches = {}, {}
    with torch.inference_mode():
        calls = stages(args.h, args.w, args.k, device)
        for name, (fn, clusters) in calls.items():
            before = center_argmin.launches
            results[name] = host_ms(fn, args.iters, warmup=5, device=device)
            if clusters:
                launches[name] = (center_argmin.launches - before) \
                    / (args.iters + 5)
        with trace(args.trace):
            calls["fusion_full"][0]()
            calls["dgc_full"][0]()
    print(f"{args.h}x{args.w}  K={args.k}")
    for name, ms in results.items():
        extra = (f"  (center_argmin launches/call {launches[name]:g})"
                 if name in launches else "")
        print(f"{name:>22s}: {ms:8.3f} ms{extra}")
    out = {"metric": "postproc_stage_ms", "hw": [args.h, args.w],
           "k": args.k, "stages_ms": {k: round(v, 4)
                                      for k, v in results.items()},
           "center_argmin_launches_per_call": launches,
           "device": str(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
