"""The fused inference frame: model + panoptic fusion + DGC depth.

Port of ``mgnet_tpu/inference/fused.py``: normalization, backbone, GCM and
three heads at stride 8 (bf16 under autocast when the model's dtype is
bf16), then float32 post-processing: channel-first bilinear upsample and
semantic argmax, panoptic fusion (with the ``center_argmin`` kernel on
CUDA), inverse-depth upsample and ``inv2depth``, ``Camera.reconstruct``,
the DGC rescale, and the depth filters.

The output dict is the JAX function's, in each combination of its
options: ``sem_seg``, ``panoptic``, ``center``, ``offset`` with
``with_panoptic``; ``depth`` with ``with_depth``, filtered by the panoptic
ids of ``depth_filter_ids`` only when the frame also has panoptic;
``points`` only with depth, DGC (``statics.use_dgc``, from
``POST_PROCESSING.USE_DGC_SCALING``), a camera matrix and
``return_point_cloud``. Without DGC or without a camera the depth is the
network's, unscaled.

The float32 post-processing does no matmul or convolution (resizes go
through ``F.interpolate``, the camera product is written out), so its
results do not depend on the TF32 flags
(``torch.backends.cuda.matmul.allow_tf32``,
``torch.backends.cudnn.allow_tf32``); those flags only reach the conv
stack when it runs in float32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from mgnet_tpu_torch.geometry.camera import Camera
from mgnet_tpu_torch.geometry.depth import inv2depth
from mgnet_tpu_torch.geometry.image import (
    interpolate_bilinear,
    interpolate_bilinear_cf,
)
from mgnet_tpu_torch.postprocessing.depth import dgc_scale_factor
from mgnet_tpu_torch.postprocessing.panoptic import panoptic_fusion
from mgnet_tpu_torch.train.step import normalize_images

__all__ = ["FusedFrame", "PostprocessStatics", "build_fused_inference",
           "fusion_kwargs", "statics_from_meta"]


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
    use_dgc: bool = True


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
        use_dgc=pp.USE_DGC_SCALING,
    )


def fusion_kwargs(s: PostprocessStatics) -> dict:
    """``panoptic_fusion``'s keyword arguments from the statics (void -1)."""
    return dict(num_classes=s.num_classes, last_stuff_id=s.last_stuff_id,
                label_divisor=s.label_divisor, stuff_area=s.stuff_area,
                void_label=-1, threshold=s.center_threshold,
                nms_kernel=s.nms_kernel, max_instances=s.max_instances)


class FusedFrame(nn.Module):
    """The fused frame as a module: ``forward`` holds the whole frame on
    tensors already on the frame's device, with no branch on a tensor's
    value (the loop over ``depth_filter_ids`` is static), so that
    ``torch.export`` traces it (``mgnet_tpu_torch.export``); calling the
    frame accepts numpy arrays too, moves them to the device and runs
    under ``torch.inference_mode``. See ``build_fused_inference``."""

    def __init__(self, model, statics: PostprocessStatics, pixel_mean,
                 pixel_std, with_panoptic: bool, with_depth: bool,
                 return_point_cloud: bool, device):
        super().__init__()
        self.model = model
        self.statics = statics
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.with_panoptic = with_panoptic
        self.with_depth = with_depth
        self.return_point_cloud = return_point_cloud
        self.device = torch.device(device)

    def __call__(self, image, camera_matrix=None,
                 camera_height=None) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            args = [None if a is None else torch.as_tensor(a,
                                                           device=self.device)
                    for a in (image, camera_matrix, camera_height)]
            return super().__call__(*args)

    def forward(self, image: torch.Tensor,
                camera_matrix: Optional[torch.Tensor] = None,
                camera_height: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        s = self.statics
        model = self.model
        out = model(normalize_images(image, self.pixel_mean, self.pixel_std))
        stride = model.common_stride
        h8, w8 = out["sem_seg" if self.with_panoptic
                     else "inv_depth"].shape[1:3]
        out_hw = (h8 * stride, w8 * stride)
        result: Dict[str, torch.Tensor] = {}

        if self.with_panoptic:
            sem_cf = interpolate_bilinear_cf(
                out["sem_seg"].permute(0, 3, 1, 2).float(), out_hw)
            sem = torch.argmax(sem_cf, dim=1).int()
            center = interpolate_bilinear(
                out["center"].float(), out_hw)[..., 0]
            offset = interpolate_bilinear(
                out["offset"].float(), out_hw) * float(stride)
            panoptic = panoptic_fusion(sem, center, offset,
                                       **fusion_kwargs(s))
            result.update(sem_seg=sem, panoptic=panoptic, center=center,
                          offset=offset)

        if self.with_depth:
            # upsample inverse depth, THEN invert (reference order)
            depth = inv2depth(
                interpolate_bilinear(out["inv_depth"], out_hw)).float()
            panoptic = result.get("panoptic")
            points = None
            if s.use_dgc and camera_matrix is not None:
                cam = Camera(camera_matrix.float())
                points = cam.reconstruct(depth, frame="c")
                ground = (panoptic == s.road_class_id) \
                    if panoptic is not None and s.road_class_id != -1 \
                    else None
                scale = dgc_scale_factor(points, camera_height,
                                         ground).reshape(-1, 1, 1, 1)
                depth = depth * scale
                points = points * scale
            depth = depth[..., 0]
            if panoptic is not None:
                for cid in s.depth_filter_ids:
                    m = panoptic == cid
                    depth = torch.where(m, 0.0, depth)
                    if points is not None:
                        points = torch.where(m[..., None], float("nan"),
                                             points)
            result["depth"] = depth
            if points is not None and self.return_point_cloud:
                result["points"] = points
        return result


def build_fused_inference(model, statics: PostprocessStatics,
                          pixel_mean, pixel_std,
                          with_panoptic: Optional[bool] = None,
                          with_depth: Optional[bool] = None,
                          return_point_cloud: bool = True,
                          device="cuda") -> FusedFrame:
    """Build the fused frame for ``model`` (an eval-mode MGNet on
    ``device``). ``with_panoptic`` and ``with_depth`` default to the
    model's own branches; a frame may leave out a branch the model has,
    and asking for one it lacks raises ``ValueError``.

    Returns a ``FusedFrame``: frame(image [B,H,W,3] raw RGB,
    camera_matrix [B,3,3] or None, camera_height [B] or None) -> dict with
        'sem_seg'   [B,H,W]   int32 argmax classes        (with_panoptic)
        'panoptic'  [B,H,W]   int32 class*divisor + inst  (with_panoptic)
        'center'    [B,H,W]   f32 heatmap                 (with_panoptic)
        'offset'    [B,H,W,2] f32                         (with_panoptic)
        'depth'     [B,H,W]   f32 depth, DGC-rescaled with a camera
                                                          (with_depth)
        'points'    [B,H,W,3] f32 camera-frame point cloud (with_depth,
                    use_dgc, a camera matrix and return_point_cloud)
    Inputs may be numpy arrays or tensors; they are moved to ``device``.
    """
    if with_panoptic is None:
        with_panoptic = model.with_panoptic
    if with_depth is None:
        with_depth = model.with_depth
    if (with_panoptic and not model.with_panoptic) \
            or (with_depth and not model.with_depth):
        raise ValueError(
            f"the frame asks for with_panoptic={with_panoptic}, "
            f"with_depth={with_depth} of a model with "
            f"with_panoptic={model.with_panoptic}, "
            f"with_depth={model.with_depth}")
    if not (with_panoptic or with_depth):
        raise ValueError("the frame needs panoptic or depth")
    return FusedFrame(model, statics, pixel_mean, pixel_std, with_panoptic,
                      with_depth, return_point_cloud, device)
