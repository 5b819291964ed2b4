"""Segmentation and instance-embedding losses.

Port of ``mgnet_tpu/losses/segmentation.py``: per-pixel cross entropy
with an ignore label, its plain mean, the top-k% hard-pixel mean
(DeepLabCE), OHEM, and the weighted center MSE / offset L1. Inputs keep
the JAX package's NHWC layout: logits [B, H, W, C], labels [B, H, W].

Hard-example selection keeps the JAX package's 24-step bisection for the
k-th largest pixel loss (``_kth_largest``), run without gradient, rather
than a sort or ``torch.topk``: the threshold it finds is approximate by
design, and parity with the JAX package needs the same approximation.

Under data parallelism (``parallel.collectives``, world > 1) every
reduction is over the global batch, as in the JAX package's SPMD step:
the bisection's maximum and counts, k and n_min from the global pixel
count, OHEM's count, sum and top-k mean, the CE valid count and the
center / offset weight sums. Sums that carry a gradient go through the
differentiable ``all_sum``; counts, maxima and weight sums through
``reduce_``. Every rank's loss is the global loss.
"""

from __future__ import annotations

import torch

from mgnet_tpu_torch.parallel.collectives import all_mean, all_sum, reduce_
from mgnet_tpu_torch.parallel.multihost import process_count

__all__ = [
    "cross_entropy_loss",
    "deeplab_ce_loss",
    "ohem_ce_loss",
    "center_loss",
    "offset_loss",
    "topk_sum",
]


def _per_pixel_ce(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_label: int):
    """Per-pixel CE (0 where ignored) and the validity mask."""
    logits = logits.float()
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = logz - picked
    return torch.where(valid, ce, torch.zeros_like(ce)), valid


def cross_entropy_loss(logits, labels, weights=None, ignore_label: int = 255):
    """Mean CE over non-ignored pixels, with optional per-pixel weights."""
    ce, valid = _per_pixel_ce(logits, labels, ignore_label)
    if weights is not None:
        ce = ce * weights
    denom = torch.clamp(reduce_(valid.float().sum()), min=1.0)
    return all_sum(ce.sum()) / denom


@torch.no_grad()
def _kth_largest(x: torch.Tensor, k: int, iters: int = 24) -> torch.Tensor:
    """Approximate k-th largest value of flat non-negative ``x`` (all
    ranks' values): bisection on the value axis, ``iters`` steps from
    [0, max + 1e-6]."""
    lo = torch.zeros((), dtype=torch.float32, device=x.device)
    hi = reduce_(x.max(), "max") + 1e-6
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = reduce_((x > mid).sum()) >= k
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return lo


def topk_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sum of the k largest values of flat non-negative ``x`` (all ranks'
    values), without a sort: sum(x > t) + (k - count(x > t)) * t at the
    bisection's t."""
    t = _kth_largest(x, k)
    above = x > t
    count = reduce_(above.sum())
    s = all_sum(torch.where(above, x, torch.zeros_like(x)).sum())
    return s + (k - count).float() * t


def deeplab_ce_loss(logits, labels, weights=None, ignore_label: int = 255,
                    top_k_percent: float = 1.0):
    """Hard-pixel-mining CE: the mean of the top-k% pixel losses."""
    ce, _ = _per_pixel_ce(logits, labels, ignore_label)
    if weights is not None:
        ce = ce * weights
    flat = ce.reshape(-1)
    if top_k_percent >= 1.0:
        return all_mean(flat.mean())
    k = int(top_k_percent * flat.shape[0] * process_count())
    return topk_sum(flat, k) / k


def ohem_ce_loss(logits, labels, weights=None, ignore_label: int = 255,
                 ohem_threshold: float = 0.7, n_min: int = 100000):
    """Online hard example mining CE: the mean of the losses above
    -log(threshold) when more than n_min exceed it, else the mean of the
    n_min largest."""
    ce, _ = _per_pixel_ce(logits, labels, ignore_label)
    if weights is not None:
        ce = ce * weights
    flat = ce.reshape(-1).float()
    n = flat.shape[0] * process_count()
    n_min = min(n_min, n - 1)
    thresh = -torch.log(torch.tensor(ohem_threshold, dtype=torch.float32,
                                     device=flat.device))
    above = flat > thresh
    count_above = reduce_(above.sum())
    sum_above = all_sum(torch.where(above, flat, torch.zeros_like(flat))
                        .sum())
    mean_above = sum_above / torch.clamp(count_above, min=1).float()
    mean_topk = topk_sum(flat, n_min) / n_min
    return torch.where(count_above > n_min, mean_above, mean_topk)


def _weighted_sum_loss(err: torch.Tensor, weights: torch.Tensor,
                       ndim: int) -> torch.Tensor:
    if weights.dim() == ndim - 1:
        weights = weights[..., None]
    weights = weights.float()
    loss = all_sum((err * weights).sum())
    wsum = reduce_(weights.sum())
    return torch.where(wsum > 0, loss / torch.clamp(wsum, min=1e-12),
                       torch.zeros_like(loss))


def center_loss(pred, target, weights):
    """Weighted MSE of the center heatmap [B, H, W, 1], normalized by the
    weight sum; weights [B, H, W] or [B, H, W, 1]."""
    err = (pred.float() - target.float()) ** 2
    return _weighted_sum_loss(err, weights, pred.dim())


def offset_loss(pred, target, weights):
    """Weighted L1 of the offsets [B, H, W, 2], normalized by the weight
    sum; weights [B, H, W] or [B, H, W, 1] broadcast over the 2 channels
    (their sum is not doubled)."""
    err = torch.abs(pred.float() - target.float())
    return _weighted_sum_loss(err, weights, pred.dim())
