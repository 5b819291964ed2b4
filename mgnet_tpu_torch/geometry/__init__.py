"""Geometry: pixel grids, resizes, the bilinear grid sample, inverse
depth, poses, the pinhole camera and view synthesis."""

from mgnet_tpu_torch.geometry.camera import Camera
from mgnet_tpu_torch.geometry.camera_utils import (
    construct_K,
    scale_intrinsics,
    synthesis_coords,
    view_synthesis,
    view_synthesis_planar,
)
from mgnet_tpu_torch.geometry.depth import calc_smoothness, inv2depth
from mgnet_tpu_torch.geometry.image import (
    gradient_x,
    gradient_y,
    grid_sample,
    grid_sample_planar,
    image_grid,
    interpolate_bilinear,
    interpolate_bilinear_cf,
    interpolate_nearest,
    match_scales,
)
from mgnet_tpu_torch.geometry.pose import Pose

__all__ = ["Camera", "Pose", "calc_smoothness", "construct_K",
           "gradient_x", "gradient_y", "grid_sample", "grid_sample_planar",
           "image_grid", "interpolate_bilinear", "interpolate_bilinear_cf",
           "interpolate_nearest", "inv2depth", "match_scales",
           "scale_intrinsics", "synthesis_coords", "view_synthesis",
           "view_synthesis_planar"]
