"""Panoptic fusion on the device, batched.

Port of ``mgnet_tpu/postprocessing/panoptic.py``: center NMS by a
thresholded max pool, fixed-K top centers, pixel-to-center clustering (the
``center_argmin`` kernel), a per-cluster majority class vote, the
stuff-area filter and panoptic ids ``class * label_divisor + instance``.

The JAX package computes three steps in forms that suit the TPU; this port
computes the same numbers directly:

* top-K: a stable descending sort (``panoptic.py:59-84`` is a two-stage
  ``lax.top_k``). Slots keep top-K order, ties go to the lower flat index,
  and only ``scores > 0`` slots are valid;
* vote counts: a scatter-add of (cluster, class) pairs into a buffer of
  fixed size (``:213-247`` is a one-hot matmul), so that nothing waits
  for the device and the frame has static shapes for ``torch.export``;
* per-pixel lookups: gathers (``:27-56``, ``:263`` are one-hot matmuls).

Unlike the JAX function, which is written for one image and vmapped,
``panoptic_fusion`` here takes [B, H, W] batches, so the kernel launches
once per batch.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from mgnet_tpu_torch.ops.center_argmin import center_argmin, center_inputs

__all__ = ["panoptic_fusion", "find_instance_centers", "vote_counts"]


def find_instance_centers(center_heatmap: torch.Tensor, threshold: float,
                          nms_kernel: int, max_instances: int):
    """NMS'd top-K centers of [B, H, W] heatmaps.

    Returns (centers_yx [B, K, 2] f32, valid [B, K] bool, scores [B, K]).
    """
    b, h, w = center_heatmap.shape
    c = center_heatmap.float()
    c = torch.where(c > threshold, c, -1.0)
    pad = (nms_kernel - 1) // 2
    pooled = F.max_pool2d(c[:, None], nms_kernel, stride=1,
                          padding=pad)[:, 0]
    keep = torch.where(c == pooled, c, -1.0)
    scores, flat_idx = torch.sort(keep.reshape(b, -1), dim=1,
                                  descending=True, stable=True)
    scores = scores[:, :max_instances]
    flat_idx = flat_idx[:, :max_instances]
    ys = torch.div(flat_idx, w, rounding_mode="floor").float()
    xs = (flat_idx % w).float()
    return torch.stack([ys, xs], dim=-1), scores > 0, scores


def vote_counts(cluster: torch.Tensor, sem: torch.Tensor, num_clusters: int,
                num_classes: int) -> torch.Tensor:
    """counts[b, k, c] = |{pixels: cluster == k and sem == c}| of [B, H, W]
    int64 cluster ids in [0, num_clusters) and classes in [0,
    num_classes): [B, num_clusters, num_classes] int32.

    A scatter-add of ones into a zeroed buffer of fixed size: integer sums,
    so any order of the atomics gives ``bincount``'s counts, and nothing is
    read back to the host to size the output (``bincount`` reads its
    input's maximum). The counts are int32 (a count is at most H * W):
    Inductor adds int32 atomically in its generated code, where an int64
    scatter falls back to ATen's sort-based ``index_put_``, which
    serialises the duplicates of a frame's few crowded bins and costs
    many times the whole frame."""
    b = cluster.shape[0]
    batch = torch.arange(b, device=cluster.device)[:, None, None]
    pair = ((batch * num_clusters + cluster) * num_classes + sem).reshape(-1)
    counts = torch.zeros(b * num_clusters * num_classes, dtype=torch.int32,
                         device=cluster.device)
    counts.index_add_(0, pair, torch.ones_like(pair, dtype=torch.int32))
    return counts.reshape(b, num_clusters, num_classes)


def _cluster_pixels(centers_yx, valid, offsets, thing_mask,
                    argmin: Callable = center_argmin) -> torch.Tensor:
    """[B, H, W] cluster ids in [0, K]: id k >= 1 is centers_yx[:, k-1];
    0 = stuff or no valid center."""
    _, h, w, _ = offsets.shape
    ys = torch.arange(h, dtype=torch.float32, device=offsets.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=offsets.device)[None]
    py = (ys + offsets[..., 0]).contiguous()
    px = (xs + offsets[..., 1]).contiguous()
    assign = argmin(py, px, *center_inputs(centers_yx, valid))
    any_valid = valid.any(dim=1)[:, None, None]
    return torch.where(thing_mask & any_valid, assign + 1, 0)


def panoptic_fusion(
    sem_seg: torch.Tensor,
    center_heatmap: torch.Tensor,
    offsets: torch.Tensor,
    *,
    num_classes: int,
    last_stuff_id: int,
    label_divisor: int = 1000,
    stuff_area: int = 2048,
    void_label: int = -1,
    threshold: float = 0.3,
    nms_kernel: int = 7,
    max_instances: int = 128,
    argmin: Callable = center_argmin,
) -> torch.Tensor:
    """Fuse semantic classes and instance embeddings into panoptic ids.

    Args:
        sem_seg: [B, H, W] int semantic train ids.
        center_heatmap: [B, H, W] float center scores.
        offsets: [B, H, W, 2] float (dy, dx) offsets in pixels.
        argmin: the clustering function; ``center_argmin`` (kernel on
            CUDA) or ``center_argmin_reference``.

    Returns:
        [B, H, W] int32 panoptic map: class * label_divisor + instance
        (instance 0 for stuff), void_label where filtered.
    """
    b = sem_seg.shape[0]
    sem = sem_seg.long()
    thing_mask = sem > last_stuff_id
    centers, valid, _ = find_instance_centers(
        center_heatmap, threshold, nms_kernel, max_instances)
    cluster = _cluster_pixels(centers, valid, offsets.float(), thing_mask,
                              argmin).long()

    # row 0 of the counts is also the per-class stuff-area histogram
    counts = vote_counts(cluster, sem, max_instances + 1, num_classes)

    thing_class = torch.arange(num_classes, device=sem.device) > last_stuff_id
    voted_class = torch.argmax(torch.where(thing_class, counts, -1),
                               dim=-1)                          # [B, K+1]
    small_stuff = counts[:, 0, : last_stuff_id + 1] < stuff_area  # [B, S]

    vc_pixel = torch.gather(voted_class, 1, cluster.reshape(b, -1)
                            ).reshape(sem.shape)
    is_stuff = sem <= last_stuff_id
    small_pixel = torch.gather(
        small_stuff, 1, sem.clamp(max=last_stuff_id).reshape(b, -1)
    ).reshape(sem.shape) & is_stuff
    pan = torch.where(
        cluster > 0,
        vc_pixel * label_divisor + cluster,
        torch.where(small_pixel, void_label, sem * label_divisor),
    )
    return pan.int()
