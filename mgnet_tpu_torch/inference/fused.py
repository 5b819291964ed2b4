"""The fused inference frame: model + panoptic fusion + DGC depth.

Port of ``mgnet_tpu/inference/fused.py``: normalization, backbone, GCM and
three heads at stride 8 (bf16 under autocast when the model's dtype is
bf16), then float32 post-processing: channel-first bilinear upsample and
semantic argmax, panoptic fusion (with the ``center_argmin`` kernel on
CUDA), inverse-depth upsample and ``inv2depth``, ``Camera.reconstruct``,
the DGC rescale, and the depth filters.

The output dict is the JAX function's: ``sem_seg``, ``panoptic``,
``center``, ``offset``, ``depth``, ``points``.

The float32 post-processing does no matmul or convolution (resizes go
through ``F.interpolate``, the camera product is written out), so its
results do not depend on the TF32 flags
(``torch.backends.cuda.matmul.allow_tf32``,
``torch.backends.cudnn.allow_tf32``); those flags only reach the conv
stack when it runs in float32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from mgnet_tpu_torch.geometry.camera import Camera
from mgnet_tpu_torch.geometry.depth import inv2depth
from mgnet_tpu_torch.geometry.image import (
    interpolate_bilinear,
    interpolate_bilinear_cf,
)
from mgnet_tpu_torch.postprocessing.depth import dgc_scale_factor
from mgnet_tpu_torch.postprocessing.panoptic import panoptic_fusion
from mgnet_tpu_torch.train.step import normalize_images

__all__ = ["PostprocessStatics", "build_fused_inference", "statics_from_meta"]


class PostprocessStatics(NamedTuple):
    """Dataset facts for the fused frame."""

    num_classes: int
    last_stuff_id: int
    label_divisor: int = 1000
    stuff_area: int = 2048
    center_threshold: float = 0.3
    nms_kernel: int = 7
    max_instances: int = 128
    road_class_id: int = -1        # panoptic id (trainId * divisor)
    depth_filter_ids: Tuple[int, ...] = ()


def statics_from_meta(cfg, metadata) -> PostprocessStatics:
    """Derive statics from dataset metadata."""
    divisor = metadata.label_divisor
    stuff_ids = metadata.stuff_dataset_id_to_contiguous_id.values()
    road = next(
        (c["trainId"] for c in metadata.categories if c["name"] == "road"),
        None,
    )
    filter_ids = tuple(
        c["trainId"] * divisor
        for c in metadata.categories
        if c["name"] in cfg.INPUT.IGNORED_CATEGORIES_IN_DEPTH
    )
    pp = cfg.MODEL.POST_PROCESSING
    return PostprocessStatics(
        num_classes=len(metadata.categories),
        last_stuff_id=max(stuff_ids),
        label_divisor=divisor,
        stuff_area=pp.STUFF_AREA,
        center_threshold=pp.CENTER_THRESHOLD,
        nms_kernel=pp.NMS_KERNEL,
        max_instances=pp.MAX_INSTANCES,
        road_class_id=(road * divisor) if road is not None else -1,
        depth_filter_ids=filter_ids,
    )


def build_fused_inference(model, statics: PostprocessStatics,
                          pixel_mean, pixel_std, device="cuda"):
    """Build the fused frame for ``model`` (an eval-mode MGNet on
    ``device``).

    Returns fn(image [B,H,W,3] raw RGB, camera_matrix [B,3,3],
               camera_height [B]) -> dict with
        'sem_seg'   [B,H,W]   int32 argmax classes
        'panoptic'  [B,H,W]   int32 panoptic ids (class*divisor + inst)
        'center'    [B,H,W]   f32 heatmap
        'offset'    [B,H,W,2] f32
        'depth'     [B,H,W]   f32 metric depth (DGC-rescaled)
        'points'    [B,H,W,3] f32 camera-frame point cloud
    Inputs may be numpy arrays or tensors; they are moved to ``device``.
    """
    s = statics
    device = torch.device(device)

    @torch.inference_mode()
    def fused(image, camera_matrix, camera_height) -> Dict[str, torch.Tensor]:
        image = torch.as_tensor(image, device=device)
        out = model(normalize_images(image, pixel_mean, pixel_std))
        stride = model.common_stride
        h8, w8 = out["sem_seg"].shape[1:3]
        out_hw = (h8 * stride, w8 * stride)

        sem_cf = interpolate_bilinear_cf(
            out["sem_seg"].permute(0, 3, 1, 2).float(), out_hw)
        sem = torch.argmax(sem_cf, dim=1).int()
        center = interpolate_bilinear(out["center"].float(), out_hw)[..., 0]
        offset = interpolate_bilinear(
            out["offset"].float(), out_hw) * float(stride)
        panoptic = panoptic_fusion(
            sem, center, offset,
            num_classes=s.num_classes,
            last_stuff_id=s.last_stuff_id,
            label_divisor=s.label_divisor,
            stuff_area=s.stuff_area,
            void_label=-1,
            threshold=s.center_threshold,
            nms_kernel=s.nms_kernel,
            max_instances=s.max_instances,
        )

        # upsample inverse depth, THEN invert (reference order)
        depth = inv2depth(
            interpolate_bilinear(out["inv_depth"], out_hw)).float()
        cam = Camera(torch.as_tensor(camera_matrix, device=device).float())
        points = cam.reconstruct(depth, frame="c")
        ground = (panoptic == s.road_class_id) if s.road_class_id != -1 \
            else None
        height = torch.as_tensor(camera_height, device=device)
        scale = dgc_scale_factor(points, height, ground).reshape(-1, 1, 1, 1)
        depth = depth[..., 0] * scale[..., 0]
        points = points * scale
        for cid in s.depth_filter_ids:
            m = panoptic == cid
            depth = torch.where(m, 0.0, depth)
            points = torch.where(m[..., None], float("nan"), points)
        return dict(sem_seg=sem, panoptic=panoptic, center=center,
                    offset=offset, depth=depth, points=points)

    return fused
