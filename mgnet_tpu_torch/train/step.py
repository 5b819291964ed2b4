"""The training step: forward, losses, uncertainty weighting, backward,
clip and the optimizer; and the eval step.

Port of ``mgnet_tpu/train/step.py``: ``normalize_images``, ``unit_image``,
``compute_losses`` (the same keys in the same insertion order, which
indexes ``log_vars``: 0-2 for a panoptic-only model, 0-1 for a depth-only
one), ``apply_uncertainty``, ``make_train_step`` and ``make_eval_step``.
The forward runs under bf16 autocast when ``MODEL.COMPUTE_DTYPE ==
"bfloat16"`` (the model applies it); the losses run in float32. The BN
running statistics update during the forward, as the JAX step's mutable
``batch_stats`` do. Context frames are normalized and passed only with
``WITH_DEPTH``.

``SOLVER.GRAD_ACCUM_STEPS = k > 1`` splits the batch on dim 0 into k
contiguous micro-batches (as the JAX step's ``reshape((k, b // k) ...)``
does), runs forward and backward on each in turn (the gradients summing
in ``.grad``, the BN running statistics carried from one to the next),
scales the gradients and the metrics by 1/k, and steps the optimizer once.

``MODEL.REMAT`` runs the photometric loss under ``torch.utils.checkpoint``
(JAX: ``jax.checkpoint``, ``mgnet_tpu/train/step.py:120-122``): the warp
and SSIM forward kernels run again in the backward, in place of keeping
the warped frames.

Data parallelism (one rank per card, ``parallel``): each rank steps on its
part of the global batch (``parallel.shard_batch``: its share of each
global micro-batch) and the step computes what the JAX package's SPMD
step computes on the whole. The convention: every rank's loss IS the
global loss (the BN statistics and every loss reduction all-reduce inside
the forward, differentiably, ``parallel.collectives``), and the parameter
gradients are averaged over the ranks, once per step after the
micro-batches (one flat all-reduce, ``average_gradients``) and before the
optimizer's global-norm clip, so that the clip and ``grad_norm`` see the
global gradient. The metrics are then the global losses on every rank,
and the BN running statistics, updated alike on every rank, stay equal
without a broadcast. At a world size of 1 no collective is called.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from mgnet_tpu_torch.losses import (
    center_loss,
    cross_entropy_loss,
    deeplab_ce_loss,
    multi_view_photometric_loss,
    offset_loss,
    ohem_ce_loss,
)
from mgnet_tpu_torch.parallel.collectives import average_gradients

__all__ = ["normalize_images", "unit_image", "compute_losses",
           "apply_uncertainty", "make_eval_step", "make_train_step",
           "split_batch"]


def normalize_images(images: torch.Tensor, pixel_mean,
                     pixel_std) -> torch.Tensor:
    """uint8/float [B,H,W,3] -> normalized float32:
    /255, then (x - mean/255) / (std/255)."""
    x = images.float() / 255.0
    mean = torch.as_tensor(pixel_mean, dtype=torch.float32,
                           device=x.device) / 255.0
    std = torch.as_tensor(pixel_std, dtype=torch.float32,
                          device=x.device) / 255.0
    return (x - mean) / std


def unit_image(images: torch.Tensor) -> torch.Tensor:
    """[0, 1]-range float view of an image batch: uint8 is cast and
    divided by 255, floats pass through."""
    if images.dtype == torch.uint8:
        return images.float() / 255.0
    return images


def compute_losses(cfg, outputs: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
    """The unweighted per-task losses, in the JAX package's key order:
    loss_sem_seg, loss_center, loss_offset, loss_photometric,
    loss_smoothness."""
    losses: Dict[str, torch.Tensor] = {}
    if cfg.WITH_PANOPTIC:
        h = cfg.MODEL.SEM_SEG_HEAD
        args = (outputs["sem_seg"], batch["sem_seg"],
                batch["sem_seg_weights"])
        if h.LOSS_TYPE == "ohem":
            sem = ohem_ce_loss(*args, ignore_label=h.IGNORE_VALUE,
                               ohem_threshold=h.OHEM_THRESHOLD,
                               n_min=h.OHEM_N_MIN)
        elif h.LOSS_TYPE == "hard_pixel_mining":
            sem = deeplab_ce_loss(*args, ignore_label=h.IGNORE_VALUE,
                                  top_k_percent=h.LOSS_TOP_K)
        elif h.LOSS_TYPE == "cross_entropy":
            sem = cross_entropy_loss(*args, ignore_label=h.IGNORE_VALUE)
        else:
            raise ValueError(f"Unexpected loss type: {h.LOSS_TYPE}")
        losses["loss_sem_seg"] = sem * h.LOSS_WEIGHT
        ih = cfg.MODEL.INS_EMBED_HEAD
        losses["loss_center"] = center_loss(
            outputs["center"], batch["center"],
            batch["center_weights"]) * ih.CENTER_LOSS_WEIGHT
        losses["loss_offset"] = offset_loss(
            outputs["offset"], batch["offset"],
            batch["offset_weights"]) * ih.OFFSET_LOSS_WEIGHT
    if cfg.WITH_DEPTH:
        dh = cfg.MODEL.DEPTH_HEAD

        def photo(inv_depths, poses, K, image, context, mask):
            return multi_view_photometric_loss(
                inv_depths, poses, K, image, context, mask,
                ssim_loss_weight=dh.SSIM_LOSS_WEIGHT,
                photometric_loss_weight=dh.PHOTOMETRIC_LOSS_WEIGHT,
                smoothing_loss_weight=dh.SMOOTHING_LOSS_WEIGHT,
                automask_loss=dh.AUTOMASK_LOSS,
                photometric_reduce_op=dh.PHOTOMETRIC_REDUCE_OP,
                padding_mode=dh.PADDING_MODE,
            )

        args = (outputs["inv_depths"], outputs["poses"],
                batch["camera_matrix"], unit_image(batch["image_orig"]),
                [unit_image(batch["image_prev_orig"]),
                 unit_image(batch["image_next_orig"])],
                batch.get("reprojection_mask"))
        if cfg.MODEL.REMAT and torch.is_grad_enabled():
            losses.update(checkpoint(photo, *args, use_reentrant=False,
                                     preserve_rng_state=False))
        else:
            losses.update(photo(*args))
    return losses


def apply_uncertainty(losses: Dict[str, torch.Tensor],
                      log_vars: torch.Tensor) -> Tuple[Dict, Dict]:
    """Homoscedastic task-uncertainty weighting: loss_i <- tau exp(-s_i)
    loss_i + 0.5 s_i, tau = 1 for loss_sem_seg and 0.5 else; the metrics
    carry the raw losses and exp(s_i)."""
    weighted: Dict[str, torch.Tensor] = {}
    metrics: Dict[str, torch.Tensor] = {}
    for idx, (key, value) in enumerate(losses.items()):
        metrics[key + "_raw"] = value
        tau = 1.0 if key == "loss_sem_seg" else 0.5
        s = log_vars[idx]
        weighted[key] = tau * torch.exp(-s) * value + 0.5 * s
        metrics[key + "_uncertainty"] = torch.exp(s)
    return weighted, metrics


def split_batch(batch: Dict[str, torch.Tensor],
                k: int) -> List[Dict[str, torch.Tensor]]:
    """``k`` contiguous micro-batches of every tensor's dim 0; a batch that
    does not divide raises."""
    micro = [{} for _ in range(k)]
    for key, x in batch.items():
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} of '{key}' does not divide into "
                             f"{k} micro-batches (SOLVER.GRAD_ACCUM_STEPS)")
        m = b // k
        for i in range(k):
            micro[i][key] = x[i * m:(i + 1) * m]
    return micro


def make_train_step(cfg) -> Callable:
    """The train step: (state, batch) -> (state, metrics). ``state`` is a
    ``train.state.TrainState``, updated in place; ``batch`` holds the
    synthetic_train_batch / mapper keys as tensors on the state's device.
    The metrics are detached tensors on that device (reading them
    synchronises)."""
    pixel_mean = tuple(cfg.MODEL.PIXEL_MEAN)
    pixel_std = tuple(cfg.MODEL.PIXEL_STD)
    with_depth = cfg.WITH_DEPTH
    with_uncertainty = cfg.WITH_UNCERTAINTY
    accum = max(1, int(cfg.SOLVER.GRAD_ACCUM_STEPS))

    def loss_fn(params, batch):
        def norm(key):
            return normalize_images(batch[key], pixel_mean, pixel_std)

        context = (norm("image_prev"), norm("image_next")) if with_depth \
            else ()
        outputs = params.model.forward_train(norm("image"), *context)
        losses = compute_losses(cfg, outputs, batch)
        metrics: Dict[str, torch.Tensor] = {}
        if with_uncertainty:
            losses, metrics = apply_uncertainty(losses, params.log_vars)
        total = sum(losses.values())
        metrics.update(losses)
        metrics["loss_total"] = total
        return total, metrics

    def forward_backward(params, batch):
        total, metrics = loss_fn(params, batch)
        total.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        state.params.train()
        state.optimizer.zero_grad()
        if accum == 1:
            metrics = forward_backward(state.params, batch)
        else:
            metrics = None
            for mb in split_batch(batch, accum):
                m = forward_backward(state.params, mb)
                metrics = m if metrics is None else {
                    k: metrics[k] + v for k, v in m.items()}
            inv = 1.0 / accum
            with torch.no_grad():
                torch._foreach_mul_([p.grad for p in state.optimizer.params
                                     if p.grad is not None], inv)
            metrics = {k: v * inv for k, v in metrics.items()}
        average_gradients(state.optimizer.params)
        metrics["grad_norm"] = state.optimizer.step()
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(cfg) -> Callable:
    """The raw inference step (``mgnet_tpu/train/step.py:258-268``):
    (model, images [B, H, W, 3] raw RGB) -> the model's full-resolution
    NHWC outputs, normalized input, eval-mode BN, no gradients."""
    pixel_mean = tuple(cfg.MODEL.PIXEL_MEAN)
    pixel_std = tuple(cfg.MODEL.PIXEL_STD)

    @torch.no_grad()
    def eval_step(model, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            return model(normalize_images(images, pixel_mean, pixel_std),
                         upsample=True)
        finally:
            model.train(was_training)

    return eval_step
