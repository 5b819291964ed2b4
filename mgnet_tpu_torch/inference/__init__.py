"""Inference entry points: the fused panoptic + depth frame, the
multi-scale + flip TTA and the ``Predictor`` built on them."""

from mgnet_tpu_torch.inference.fused import (
    FusedFrame,
    PostprocessStatics,
    build_fused_inference,
    fusion_kwargs,
    statics_from_meta,
)
from mgnet_tpu_torch.inference.predictor import Predictor
from mgnet_tpu_torch.inference.tta import multi_scale_flip_inference

__all__ = [
    "FusedFrame",
    "PostprocessStatics",
    "build_fused_inference",
    "fusion_kwargs",
    "statics_from_meta",
    "Predictor",
    "multi_scale_flip_inference",
]
