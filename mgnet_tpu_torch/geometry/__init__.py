"""Geometry: pixel grids, resizes, inverse depth and the pinhole camera."""

from mgnet_tpu_torch.geometry.camera import Camera
from mgnet_tpu_torch.geometry.depth import inv2depth
from mgnet_tpu_torch.geometry.image import (
    image_grid,
    interpolate_bilinear,
    interpolate_bilinear_cf,
    interpolate_nearest,
)

__all__ = ["Camera", "inv2depth", "image_grid", "interpolate_bilinear",
           "interpolate_bilinear_cf", "interpolate_nearest"]
