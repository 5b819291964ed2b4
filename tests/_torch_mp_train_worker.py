"""Worker of the port's two-rank data-parallel tests
(test_torch_distributed.py).

    python _torch_mp_train_worker.py RANK PORT STATE OUT [cuda]

Joins a gloo group of two on localhost (one intra-op thread), runs every
case below on its part of the global inputs, and saves {case: results} to
``OUT/rank<RANK>.pt``. With ``cuda`` both ranks share the card (gloo
carries CUDA tensors; NCCL refuses two ranks on one device), TF32 off,
and run the two training steps only (tests/test_torch_gpu.py). Each
case function, called with ``world=1``, is the one-process reference on
the whole of the same inputs. ``STATE`` is the state_dict that both
training steps start from.

Gradients of inputs are those of the global loss: every rank's loss is
the global loss, so the backward from every rank gives each rank
``world`` times its inputs' share, which the cases divide out.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch

from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.data import TrainLoader, synthetic_train_batch
from mgnet_tpu_torch.losses import (
    center_loss,
    cross_entropy_loss,
    deeplab_ce_loss,
    multi_view_photometric_loss,
    offset_loss,
    ohem_ce_loss,
)
from mgnet_tpu_torch.models import as_float64_, build_model
from mgnet_tpu_torch.models.abn import ABN
from mgnet_tpu_torch.parallel import (
    initialize_distributed,
    shard_batch,
    shutdown_distributed,
    synchronize,
)
from mgnet_tpu_torch.train import create_train_state, make_train_step
from mgnet_tpu_torch.utils.checkpoint import CheckpointManager
from mgnet_tpu_torch.utils.events import MetricLogger

WORLD = 2
# losses: a global batch of 4 (2 per rank) of 16x16 pixels, 5 classes;
# 512 pixels per rank, 1024 in all, so n_min 700 lies between the two
LB, LH, LW, LC = 4, 16, 16, 5
N_MIN = 700
# the training steps: test_torch_train_step.py's shapes and widths
H = W = 64
WIDTHS = dict(GCM=32, HEAD=32, FFM=48, ARM=[32, 32], REFINE=[32, 32])
PLAIN_BATCH, PLAIN_SEED = 2, 5
ACCUM_BATCH, ACCUM_SEED = 4, 6


def step_config(accum: int = 1, remat: bool = False):
    """test_torch_train_step.py's port config: narrow heads, f32,
    OHEM_N_MIN 3000; with ``accum`` micro-batches and ``remat``."""
    cfg = get_default_config()
    for head in (cfg.MODEL.SEM_SEG_HEAD, cfg.MODEL.INS_EMBED_HEAD,
                 cfg.MODEL.DEPTH_HEAD):
        head.HEAD_CHANNELS = WIDTHS["HEAD"]
        head.FFM_CHANNELS = WIDTHS["FFM"]
        head.ARM_CHANNELS = list(WIDTHS["ARM"])
        head.REFINE_CHANNELS = list(WIDTHS["REFINE"])
    cfg.MODEL.GCM.GCM_CHANNELS = WIDTHS["GCM"]
    cfg.MODEL.COMPUTE_DTYPE = "float32"
    cfg.MODEL.SEM_SEG_HEAD.OHEM_N_MIN = 3000
    cfg.SOLVER.WARMUP_ITERS = 10
    cfg.SOLVER.MAX_ITER = 100
    cfg.SOLVER.GRAD_ACCUM_STEPS = accum
    cfg.MODEL.REMAT = remat
    return cfg


def step_batch(accum: int):
    """The global batch of the plain (accum 1) or accumulating step."""
    b, seed = (PLAIN_BATCH, PLAIN_SEED) if accum == 1 else \
        (ACCUM_BATCH, ACCUM_SEED)
    batch = synthetic_train_batch(b, H, W, seed=seed)
    batch.pop("camera_height")
    return batch


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def step_state(cfg, state_dict, device="cpu", float64=False):
    model = build_model(cfg, device="cpu", for_training=True)
    if float64:
        as_float64_(model)
    state = create_train_state(cfg, model.to(device))
    state.params.load_state_dict(state_dict)
    return state


def step_case(state_dict, accum: int, remat: bool, rank: int, world: int,
              device="cpu", float64=False):
    """One training step from ``state_dict`` on this rank's part of the
    global batch: the metrics, the (averaged) gradients, the BN running
    statistics and every parameter and buffer after it, on the CPU. With
    ``float64`` the model runs as its float64 reference
    (``models.as_float64_``)."""
    cfg = step_config(accum, remat)
    state = step_state(cfg, state_dict, device, float64)
    batch = {k: v.to(device) for k, v in shard_batch(
        _tensors(step_batch(accum)), accum, rank, world).items()}
    _, metrics = make_train_step(cfg)(state, batch)
    sd = state.params.state_dict()
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={n: p.grad.cpu().clone() for n, p in
               state.params.named_parameters() if p.grad is not None},
        stats={k: v.cpu().clone() for k, v in sd.items()
               if k.endswith(("running_mean", "running_var"))},
        params={k: v.cpu().clone() for k, v in sd.items()})


STEP_CASES = {"step/plain": (1, False), "step/accum_remat": (2, True)}


def loss_inputs():
    """The global inputs of the loss cases, from a seed."""
    rng = np.random.RandomState(3)
    f32 = np.float32
    labels = rng.randint(0, LC, (LB, LH, LW)).astype(np.int32)
    labels[rng.rand(LB, LH, LW) < 0.1] = 255
    return dict(
        logits=(rng.randn(LB, LH, LW, LC) * 2).astype(f32),
        labels=labels,
        weights=rng.uniform(0.5, 2.0, (LB, LH, LW)).astype(f32),
        center=rng.rand(LB, LH, LW, 1).astype(f32),
        center_t=rng.rand(LB, LH, LW, 1).astype(f32),
        center_w=(rng.rand(LB, LH, LW) < 0.6).astype(f32),
        offset=rng.randn(LB, LH, LW, 2).astype(f32),
        offset_t=rng.randn(LB, LH, LW, 2).astype(f32),
        # the last sample has no instance pixel
        offset_w=np.concatenate([(rng.rand(LB - 1, LH, LW, 1) < 0.5),
                                 np.zeros((1, LH, LW, 1), bool)]).astype(f32),
        inv_depths=[rng.uniform(0.2, 1.0, (LB, LH, LW, 1)).astype(f32)
                    for _ in range(3)],
        poses=(rng.randn(LB, 2, 6) * 0.02).astype(f32),
        K=np.tile(np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], f32),
                  (LB, 1, 1)),
        image=rng.rand(LB, LH, LW, 3).astype(f32),
        context=[rng.rand(LB, LH, LW, 3).astype(f32) for _ in range(2)],
        mask=(rng.rand(LB, LH, LW, 1) < 0.8).astype(f32),
    )


def _part(x, rank: int, world: int):
    b = x.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(x[rank * b:(rank + 1) * b]))


LOSS_CASES = ("ohem_above", "ohem_topk", "deeplab_topk", "deeplab_mean",
              "cross_entropy", "center", "offset", "photometric",
              "smoothness")


def loss_case(name: str, rank: int, world: int):
    """The loss ``name`` on this rank's part of loss_inputs(): its value
    and the gradients of its differentiable inputs (this rank's part)."""
    g = loss_inputs()

    def leaf(x):
        return _part(x, rank, world).requires_grad_(True)

    labels = _part(g["labels"], rank, world)
    weights = _part(g["weights"], rank, world)
    if name.startswith(("ohem", "deeplab", "cross")):
        x = {"logits": leaf(g["logits"])}
        args = (x["logits"], labels, weights)
        if name == "ohem_above":
            loss = ohem_ce_loss(*args, ohem_threshold=0.7, n_min=N_MIN)
        elif name == "ohem_topk":
            # -log(0.05) ~ 3.0: fewer than n_min pixels above it
            loss = ohem_ce_loss(*args, ohem_threshold=0.05, n_min=N_MIN)
        elif name == "deeplab_topk":
            loss = deeplab_ce_loss(*args, top_k_percent=0.2)
        elif name == "deeplab_mean":
            loss = deeplab_ce_loss(*args, top_k_percent=1.0)
        else:
            loss = cross_entropy_loss(*args)
    elif name == "center":
        x = {"pred": leaf(g["center"])}
        loss = center_loss(x["pred"], _part(g["center_t"], rank, world),
                           _part(g["center_w"], rank, world))
    elif name == "offset":
        x = {"pred": leaf(g["offset"])}
        loss = offset_loss(x["pred"], _part(g["offset_t"], rank, world),
                           _part(g["offset_w"], rank, world))
    else:
        x = {f"inv_depth{i}": leaf(d) for i, d in enumerate(g["inv_depths"])}
        x["poses"] = leaf(g["poses"])
        out = multi_view_photometric_loss(
            [x[f"inv_depth{i}"] for i in range(3)], x["poses"],
            _part(g["K"], rank, world), _part(g["image"], rank, world),
            [_part(c, rank, world) for c in g["context"]],
            _part(g["mask"], rank, world))
        loss = out["loss_" + name]
    loss.backward()
    return dict(value=float(loss.detach()),
                grads={k: v.grad / world for k, v in x.items()
                       if v.grad is not None})


ABN_CASES = {
    # name: (global shape [B, C, H, W], fast variance)
    "fast": ((4, 6, 5, 7), True),
    "fast_one_sample_per_rank": ((2, 6, 5, 7), True),
    "two_pass": ((4, 6, 5, 7), False),
    # the pooled [B, C, 1, 1] sites (two-pass, as in the model) at one
    # sample per rank, where a rank's own variance would be 0
    "pooled": ((2, 6, 1, 1), False),
}


def abn_case(name: str, rank: int, world: int):
    """One training-mode ABN forward of this rank's part of a seeded input
    and the backward of a seeded upstream gradient: the output, the input
    gradient, this rank's share of the scale and bias gradients and the
    running statistics after."""
    shape, fast = ABN_CASES[name]
    rng = np.random.RandomState(7)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    up = rng.randn(*shape).astype(np.float32)
    m = ABN(shape[1], "leaky_relu", fast_variance=fast)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(
            rng.uniform(0.5, 1.5, shape[1]).astype(np.float32)))
        m.bias.copy_(torch.from_numpy(
            rng.randn(shape[1]).astype(np.float32) * 0.1))
        m.running_mean.copy_(torch.from_numpy(
            rng.randn(shape[1]).astype(np.float32)))
        m.running_var.copy_(torch.from_numpy(
            rng.uniform(0.5, 2.0, shape[1]).astype(np.float32)))
    m.train()
    xr = _part(x, rank, world).requires_grad_(True)
    y = m(xr)
    y.backward(_part(up, rank, world))
    # the scale of a BN input gradient: |upstream| x |scale| / std (at
    # the pooled site with two values that gradient is 0 analytically)
    return dict(grad_scale=float(np.abs(up).max()
                                 * m.weight.detach().abs().max()
                                 / np.sqrt(x.var(axis=(0, 2, 3)).min())),
                out=y.detach(), x_grad=xr.grad, weight_grad=m.weight.grad,
                bias_grad=m.bias.grad, running_mean=m.running_mean.clone(),
                running_var=m.running_var.clone())


def loader_batches(rank: int, world: int, micro_batches: int,
                   n: int = 4):
    """The first ``n`` batches (global batch 4 over 10 samples, so they
    cross an epoch) of a TrainLoader for process ``rank`` of ``world``."""
    dataset = [{"i": i} for i in range(10)]

    def mapper(d, rng):
        return {"index": np.int64(d["i"]),
                "noise": rng.random(3).astype(np.float32),
                "image": np.full((4, 4, 3), d["i"], np.uint8)}

    loader = TrainLoader(dataset, mapper, batch_size=4, seed=3,
                         num_workers=2, process_index=rank,
                         process_count=world, micro_batches=micro_batches)
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        loader.close()


def checkpoint_case(state_dict, out: Path, rank: int):
    """Every rank saves a checkpoint and logs a metric into its own
    directory (only rank 0's may hold files), then, after a barrier,
    restores rank 0's checkpoint into a fresh state."""
    cfg = step_config()
    state = step_state(cfg, state_dict)
    state.step = 7
    mine = out / f"ckpt_rank{rank}"
    CheckpointManager(str(mine)).save(7, state)
    MetricLogger(str(out / f"log_rank{rank}")).log(7, {"loss": 1.0})
    synchronize()
    fresh = step_state(cfg, {k: torch.zeros_like(v)
                             for k, v in state_dict.items()})
    fresh, restored = CheckpointManager(str(out / "ckpt_rank0")).restore(
        fresh)
    return dict(
        files=sorted(os.listdir(mine)),
        log_files=sorted(os.listdir(out / f"log_rank{rank}"))
        if (out / f"log_rank{rank}").is_dir() else [],
        restored=restored, step=fresh.step,
        params={k: v.clone() for k, v in fresh.params.state_dict().items()})


def run_all(state_dict, out: Path, rank: int, world: int, device="cpu"):
    if torch.device(device).type != "cpu":
        return {k: step_case(state_dict, *v, rank, world, device)
                for k, v in STEP_CASES.items()}
    results = {f"loss/{n}": loss_case(n, rank, world) for n in LOSS_CASES}
    results.update({f"abn/{n}": abn_case(n, rank, world)
                    for n in ABN_CASES})
    results.update({k: step_case(state_dict, *v, rank, world)
                    for k, v in STEP_CASES.items()})
    for k in (1, 2):
        results[f"loader/{k}"] = loader_batches(rank, world, k)
    results["checkpoint"] = checkpoint_case(state_dict, out, rank)
    return results


def main(rank: int, port: int, state_path: str, out: str,
         device: str = "cpu") -> None:
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = initialize_distributed(f"127.0.0.1:{port}", WORLD, rank,
                                    device=device, backend="gloo")
    try:
        state_dict = torch.load(state_path, weights_only=True)
        results = run_all(state_dict, Path(out), rank, WORLD, device)
        torch.save(results, Path(out) / f"rank{rank}.pt")
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])
