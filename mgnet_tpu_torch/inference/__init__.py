"""Inference entry points: the fused panoptic + depth frame."""

from mgnet_tpu_torch.inference.fused import (
    PostprocessStatics,
    build_fused_inference,
    statics_from_meta,
)

__all__ = ["PostprocessStatics", "build_fused_inference", "statics_from_meta"]
