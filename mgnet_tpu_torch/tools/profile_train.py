"""Training-step ledger of the port: the full step's time by stage,
rows that sum exactly to the measured step.

    python -m mgnet_tpu_torch.tools.profile_train [--batch 8] [--size 1024]
        [--iters 8] [--roofline] [--trace DIR] [--device cuda]

The counterpart of ``tools/profile_train.py``, by the same telescoping
structural ablation: variant i removes one more stage than variant i-1,

  T0 full step
  T1 surrogate warp      the warp (``mgnet::warp_bilinear``) replaced by
                         elementwise math of the same shapes that keeps
                         the coordinates' graph (``_surrogate_grid_sample``)
  T2 + L1-only residual  both SSIM kernels replaced by the L1 residual
                         (``_l1_residual_planar``)
  T3 no depth branch     ``WITH_DEPTH False``
  T4 + plain CE          ``LOSS_TYPE cross_entropy`` (no OHEM)
  T5 forward-only        the T4 model's forward and losses, no backward,
                         no optimizer

and each ledger row is T(i-1) - T(i), the last row T5 itself, so the rows
sum to the full step by construction. The surrogates go in by patching
the port's module attributes (``geometry.camera_utils.grid_sample_planar``,
``losses.photometric.fused_photometric_residual``), restored in a
``finally``. Each variant is a fresh seeded state and the seeded
synthetic batch (the default config, ``OHEM_N_MIN`` a quarter of a
crop), timed on the host clock around ``--iters`` steps after 2 warmup,
the card synchronised at both ends; the hand-written kernels' launches
per step are counted for each.

``--roofline`` adds each row's matrix FLOPs (convolutions and matrix
products, forward and backward, by ``FlopCounterMode`` on one step of
each variant: the elementwise work and the hand-written kernels are not
counted) and its share of the H100's dense bf16 peak, 989 TFLOP/s
(``utils.profiling.PEAK_BF16_FLOPS``). No count of a row's bytes is
honest here, so none is printed.
``--trace DIR`` captures one full step with ``torch.profiler``. The last
line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import torch

import mgnet_tpu_torch.geometry.camera_utils as camera_utils
import mgnet_tpu_torch.losses.photometric as photometric
from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.tools.bench_train import kernel_launches, train_inputs
from mgnet_tpu_torch.train.step import (
    apply_uncertainty,
    compute_losses,
    normalize_images,
)
from mgnet_tpu_torch.utils.profiling import (
    PEAK_BF16_FLOPS,
    count_flops,
    device_line,
    host_ms,
    require_device,
    sync,
    trace,
)

__all__ = ["LEDGER", "VARIANTS", "ledger", "main", "parse_args",
           "time_variant"]

# (name, config overrides, surrogate warp, L1-only residual, forward-only)
VARIANTS = [
    ("T0 full step", {}, False, False, False),
    ("T1 surrogate warp", {}, True, False, False),
    ("T2 + L1-only residual", {}, True, True, False),
    ("T3 no depth branch", {"WITH_DEPTH": False}, False, False, False),
    ("T4 + plain CE", {"WITH_DEPTH": False,
                       "MODEL.SEM_SEG_HEAD.LOSS_TYPE": "cross_entropy"},
     False, False, False),
    ("T5 forward-only", {"WITH_DEPTH": False,
                         "MODEL.SEM_SEG_HEAD.LOSS_TYPE": "cross_entropy"},
     False, False, True),
]
# the ledger's row i: T(i) - T(i+1), the last T5 itself
LEDGER = [
    "warp_6x_fwd_bwd",
    "ssim_residuals_8x_fwd_6x_bwd",
    "depth_branch_rest (pose+decoder+3 upsamples+smoothness+reduce+L1)",
    "ohem_overhead",
    "panoptic_backward_plus_optimizer",
    "panoptic_forward (backbone+GCM+2 decoders+CE fwd)",
]


def _surrogate_grid_sample(image, coords, padding_mode="zeros"):
    """Gather-free stand-in for the warp: the same shapes (planar
    [B, C, H, W] out), the coordinates' whole graph and its gradients to
    depth and pose kept, the four-corner gather replaced by elementwise
    math (the JAX tool's surrogate, planar)."""
    blend = (coords[..., :1] + coords[..., 1:]) * 0.01
    return image * 0.999 + blend.permute(0, 3, 1, 2)


def _l1_residual_planar(warped, image, ssim_weight=0.85):
    """SSIM-free residual [B, H, W] with the fused residual's signature:
    the channel mean of |warped - image|."""
    return torch.abs(warped - image).mean(dim=1)


def _forward_only_step(cfg):
    """(state, batch) -> (state, {"loss_total"}): the training model's
    forward and losses without gradient (BN statistics still update)."""
    pm, ps = tuple(cfg.MODEL.PIXEL_MEAN), tuple(cfg.MODEL.PIXEL_STD)

    def step(state, batch):
        state.params.train()
        with torch.no_grad():
            context = ()
            if cfg.WITH_DEPTH:
                context = tuple(normalize_images(batch[k], pm, ps)
                                for k in ("image_prev", "image_next"))
            outputs = state.params.model.forward_train(
                normalize_images(batch["image"], pm, ps), *context)
            losses = compute_losses(cfg, outputs, batch)
            if cfg.WITH_UNCERTAINTY:
                losses, _ = apply_uncertainty(losses, state.params.log_vars)
            total = sum(losses.values())
        return state, {"loss_total": total}

    return step


def time_variant(variant, batch: int, size: int, iters: int, device,
                 flops: bool = False, trace_dir: str = "",
                 opts=()) -> dict:
    """One variant (after the config overrides ``opts``): its ms/step,
    launches per step and (``flops``) its matrix FLOPs per step; the
    patches restored whatever happens."""
    name, overrides, warp, residual, fwd_only = variant
    cfg = get_default_config()
    cfg.MODEL.SEM_SEG_HEAD.OHEM_N_MIN = (size * size // 4) - 1
    cfg.merge_from_list(list(opts))
    cfg.merge_from_list([str(x) for kv in overrides.items() for x in kv])
    saved = (camera_utils.grid_sample_planar,
             photometric.fused_photometric_residual)
    try:
        if warp:
            camera_utils.grid_sample_planar = _surrogate_grid_sample
        if residual:
            photometric.fused_photometric_residual = _l1_residual_planar
        state, step, data = train_inputs(cfg, batch, size, device)
        if fwd_only:
            step = _forward_only_step(cfg)
        last = {}

        def one():
            last["m"] = step(state, data)[1]

        before = kernel_launches()
        ms = host_ms(one, iters, warmup=2, device=device)
        launches = {k: (v - before[k]) / (iters + 2)
                    for k, v in kernel_launches().items()}
        loss = float(last["m"]["loss_total"])
        if loss != loss:
            raise RuntimeError(f"{name}: non-finite loss")
        out = {"ms": ms, "launches_per_step": launches, "loss": loss}
        if flops:
            out["flops"] = count_flops(one)
        if trace_dir:
            with trace(trace_dir):
                one()
                sync(device)
    finally:
        camera_utils.grid_sample_planar, \
            photometric.fused_photometric_residual = saved
    print(f"# {name}: {ms:.3f} ms/step, launches per step {launches}",
          file=sys.stderr, flush=True)
    return out


def ledger(times: List[float]) -> dict:
    """The telescoping rows of the variants' times (ms)."""
    return {row: times[i] - (times[i + 1] if i + 1 < len(times) else 0.0)
            for i, row in enumerate(LEDGER)}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--roofline", action="store_true",
                   help="add each row's matrix FLOPs and its share of "
                        "the H100's dense bf16 peak (989 TFLOP/s)")
    p.add_argument("--trace", default="",
                   help="torch.profiler trace of one full step into this "
                        "directory")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="config overrides of every variant (KEY VALUE ...)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    device = require_device(args.device)
    print(device_line(device), file=sys.stderr)
    runs = {v[0]: time_variant(v, args.batch, args.size, args.iters, device,
                               flops=args.roofline,
                               trace_dir=args.trace if i == 0 else "",
                               opts=args.opts)
            for i, v in enumerate(VARIANTS)}
    times = [r["ms"] for r in runs.values()]
    rows = ledger(times)
    out = {"batch": args.batch, "size": args.size,
           "full_step_ms": round(times[0], 4),
           "ledger_ms": {k: round(v, 4) for k, v in rows.items()},
           "ledger_sum_ms": round(sum(rows.values()), 4),
           "launches_per_step": {k: r["launches_per_step"]
                                 for k, r in runs.items()},
           "device": str(device)}
    if args.roofline:
        fl = [r["flops"] for r in runs.values()]
        roof = {}
        for i, row in enumerate(LEDGER):
            d = fl[i] - (fl[i + 1] if i + 1 < len(fl) else 0)
            dt = max(rows[row], 1e-9) / 1e3
            roof[row] = {"gflops": round(d / 1e9, 1),
                         "peak_share_pct": round(
                             100 * d / dt / PEAK_BF16_FLOPS, 2)}
        roof["FULL STEP"] = {
            "gflops": round(fl[0] / 1e9, 1),
            "peak_share_pct": round(
                100 * fl[0] / (times[0] / 1e3) / PEAK_BF16_FLOPS, 2)}
        out["roofline"] = roof
        out["peak_tflops"] = PEAK_BF16_FLOPS / 1e12
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
