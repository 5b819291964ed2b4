"""Training-step throughput of the port (synthetic batch, on the card).

    python -m mgnet_tpu_torch.tools.bench_train [--batch 4] [--size 1024]
        [--iters 10] [--depth-only | --no-depth] [--remat] [--accum K]
        [--trace DIR] [--device cuda]

The counterpart of ``tools/bench_train.py``: the default config (the
joint model, heads, PoseCNN, every loss and Adam), ``OHEM_N_MIN`` at a
quarter of a crop's pixels, on a seeded synthetic batch of ``--batch``
crops of ``--size`` squared, the weights drawn from seed 0. ``--accum``
is ``SOLVER.GRAD_ACCUM_STEPS`` (``--batch`` the global batch). Prints the
first step's seconds, then the steady step: the host clock around
``--iters`` steps after 3 warmup, the card synchronised at both ends
(ms/step, images/s, the last loss), the peak memory, the hand-written
kernels' launches per step, and the device the numbers come from. Its
last line is one JSON object. ``--trace DIR`` captures one more step with
``torch.profiler`` into DIR.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.data import synthetic_train_batch
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.ops.ssim import ssim_residual_bwd, ssim_residual_fwd
from mgnet_tpu_torch.ops.warp import warp_bilinear
from mgnet_tpu_torch.train import create_train_state, make_train_step
from mgnet_tpu_torch.utils.profiling import (
    device_line,
    host_ms,
    peak_hbm_gb,
    require_device,
    sync,
    trace,
)

__all__ = ["KERNELS", "bench_config", "kernel_launches", "main",
           "parse_args", "train_inputs"]

# the training step's hand-written kernels
KERNELS = {"warp_bilinear": warp_bilinear,
           "ssim_residual_fwd": ssim_residual_fwd,
           "ssim_residual_bwd": ssim_residual_bwd}


def kernel_launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--depth-only", action="store_true")
    p.add_argument("--no-depth", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--accum", type=int, default=1,
                   help="SOLVER.GRAD_ACCUM_STEPS: --batch is the global "
                        "batch, run as this many micro-batches a step")
    p.add_argument("--trace", default="",
                   help="torch.profiler trace of one step into this "
                        "directory")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="further config overrides (KEY VALUE ...)")
    return p.parse_args(argv)


def bench_config(args):
    """The default config with the tool's switches applied."""
    cfg = get_default_config()
    cfg.MODEL.SEM_SEG_HEAD.OHEM_N_MIN = (args.size * args.size // 4) - 1
    if args.depth_only:
        cfg.WITH_PANOPTIC = False
    if args.no_depth:
        cfg.WITH_DEPTH = False
    cfg.MODEL.REMAT = bool(args.remat)
    cfg.SOLVER.GRAD_ACCUM_STEPS = max(1, args.accum)
    cfg.merge_from_list(list(args.opts))
    return cfg


def train_inputs(cfg, batch: int, size: int, device):
    """(train state, step, batch on ``device``): weights from seed 0, the
    seeded synthetic batch."""
    model = build_model(cfg, device="cpu", for_training=True)
    init_random_(model, torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model.to(device))
    data = synthetic_train_batch(batch, size, size)
    data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in data.items()}
    return state, make_train_step(cfg), data


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    device = require_device(args.device)
    cfg = bench_config(args)
    state, step, batch = train_inputs(cfg, args.batch, args.size, device)
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"params: {n_params / 1e6:.1f} M")
    print(device_line(device))

    t0 = time.perf_counter()
    _, metrics = step(state, batch)
    float(metrics["loss_total"])
    print(f"first step: {time.perf_counter() - t0:.1f} s")
    for _ in range(2):
        step(state, batch)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    last = {}

    def one():
        last["m"] = step(state, batch)[1]

    before = kernel_launches()
    ms = host_ms(one, args.iters, warmup=1, device=device)
    launches = {k: (v - before[k]) / (args.iters + 1)
                for k, v in kernel_launches().items()}
    loss = float(last["m"]["loss_total"])
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    peak = peak_hbm_gb(device)
    with trace(args.trace):
        one()
        sync(device)
    print(f"step time: {ms:.1f} ms ({args.batch / ms * 1e3:.2f} img/s, "
          f"loss={loss:.3f}); peak {peak} GiB; kernel launches per step "
          f"{launches}")
    result = {"metric": "train_step_ms", "value": round(ms, 3),
              "images_per_s": round(args.batch / ms * 1e3, 3),
              "batch": args.batch, "size": args.size, "accum": args.accum,
              "loss_total": loss, "peak_gib": peak,
              "launches_per_step": launches, "device": str(device)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
