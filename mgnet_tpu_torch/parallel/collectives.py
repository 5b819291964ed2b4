"""The collectives of data-parallel training.

The JAX package's training step is one SPMD program over the global
batch, so its BN statistics and every loss reduction are over the global
batch without a collective written anywhere. The port runs one process
per card, each with its slice of the batch; these functions are the
reductions that make its numbers the global batch's:

* ``all_sum`` — a differentiable SUM over the ranks; its backward is the
  SUM of the ranks' gradients (every rank's loss is the global loss, so
  each rank's gradient of a local value is the sum of what every rank's
  loss asks of it);
* ``all_mean`` — ``all_sum / world``: the mean of equal-sized per-rank
  means, the global mean;
* ``reduce_`` — a SUM or MAX in place, without gradient, for counts,
  maxima and mask sums;
* ``average_gradients`` — the ranks' mean gradient of every parameter,
  one flat all-reduce after the backward.

At a world size of 1 each is the identity and calls nothing, so the
one-card path runs exactly the operations it ran before. They use
all-reduce only, which gloo also runs on CUDA tensors (two gloo ranks can
share one card; NCCL refuses that). ``CALLS`` counts the collectives
called in this process.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

from mgnet_tpu_torch.parallel.multihost import process_count

__all__ = ["CALLS", "all_mean", "all_sum", "average_gradients", "reduce_"]

# collectives called in this process (forward, backward and no-grad ones)
CALLS = {"all_reduce": 0}


def _all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    CALLS["all_reduce"] += 1
    dist.all_reduce(x, op=op)
    return x


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone())


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable; ``x`` at world 1."""
    return _AllSum.apply(x) if process_count() > 1 else x


def all_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks, differentiable; ``x`` at
    world 1."""
    world = process_count()
    return _AllSum.apply(x) / world if world > 1 else x


@torch.no_grad()
def reduce_(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``x`` reduced in place over the ranks by "sum" or "max", without
    gradient; ``x`` itself at world 1. Only for a fresh tensor that no
    graph holds."""
    if process_count() > 1:
        _all_reduce(x, dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX)
    return x


@torch.no_grad()
def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace every gradient by its mean over the ranks, through one
    all-reduce of a flat bucket; a parameter without a gradient gets
    zeros (the optimizer reads a missing gradient as zeros). Nothing at
    world 1."""
    world = process_count()
    if world == 1:
        return
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce(flat).div_(world)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p)
        offset += n
