"""Intrinsics scaling and view synthesis (the warp of the photometric
loss).

Port of ``mgnet_tpu/geometry/camera_utils.py``: ``construct_K`` (a numpy
[3, 3] intrinsics matrix), ``scale_intrinsics``
(pixel-center convention), ``synthesis_coords`` (the planar per-pixel
affine chain reconstruct -> world -> reference camera -> project, with the
clamp ``pz >= 1e-5``), and ``view_synthesis`` / ``view_synthesis_planar``
(those coordinates, then the bilinear warp). Gradients flow through the
coordinates into the depth and the pose.
"""

from __future__ import annotations

import numpy as np
import torch

from mgnet_tpu_torch.geometry.image import grid_sample, grid_sample_planar

__all__ = ["construct_K", "scale_intrinsics", "synthesis_coords",
           "view_synthesis", "view_synthesis_planar"]


def construct_K(fx: float, fy: float, cx: float, cy: float,
                dtype=np.float32) -> np.ndarray:
    """A [3, 3] pinhole intrinsics matrix (host side)."""
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=dtype)


def scale_intrinsics(K: torch.Tensor, x_scale, y_scale) -> torch.Tensor:
    """f *= scale; c = (c + 0.5) * scale - 0.5 (returns a new K)."""
    out = K.clone()
    out[..., 0, 0] = K[..., 0, 0] * x_scale
    out[..., 1, 1] = K[..., 1, 1] * y_scale
    out[..., 0, 2] = (K[..., 0, 2] + 0.5) * x_scale - 0.5
    out[..., 1, 2] = (K[..., 1, 2] + 0.5) * y_scale - 0.5
    return out


def synthesis_coords(depth: torch.Tensor, ref_cam, cam) -> torch.Tensor:
    """Normalized sampling coords [B, H, W, 2] (x, y) that warp the
    reference image into ``cam``'s view, for depth [B, H, W, 1]."""
    b, h, w, _ = depth.shape
    f32 = torch.float32
    d = depth[..., 0].to(f32)
    u = torch.arange(w, dtype=f32, device=depth.device)[None, None, :]
    v = torch.arange(h, dtype=f32, device=depth.device)[None, :, None]

    def c(m, i, j):
        return m[:, i, j][:, None, None]

    kinv = cam.Kinv.to(f32)
    rx = c(kinv, 0, 0) * u + c(kinv, 0, 1) * v + c(kinv, 0, 2)
    ry = c(kinv, 1, 0) * u + c(kinv, 1, 1) * v + c(kinv, 1, 2)
    rz = c(kinv, 2, 0) * u + c(kinv, 2, 1) * v + c(kinv, 2, 2)
    x, y, z = rx * d, ry * d, rz * d

    # cam frame -> world (cam.Twc) -> reference camera (ref_cam.Tcw), one
    # 4x4 per batch element
    m = ref_cam.Tcw.transform_pose(cam.Twc).mat.to(f32)
    xr = c(m, 0, 0) * x + c(m, 0, 1) * y + c(m, 0, 2) * z + c(m, 0, 3)
    yr = c(m, 1, 0) * x + c(m, 1, 1) * y + c(m, 1, 2) * z + c(m, 1, 3)
    zr = c(m, 2, 0) * x + c(m, 2, 1) * y + c(m, 2, 2) * z + c(m, 2, 3)

    k = ref_cam.K.to(f32)
    px = c(k, 0, 0) * xr + c(k, 0, 1) * yr + c(k, 0, 2) * zr
    py = c(k, 1, 0) * xr + c(k, 1, 1) * yr + c(k, 1, 2) * zr
    pz = c(k, 2, 0) * xr + c(k, 2, 1) * yr + c(k, 2, 2) * zr
    pz = torch.clamp(pz, min=1e-5)
    xnorm = 2.0 * (px / pz) / (w - 1) - 1.0
    ynorm = 2.0 * (py / pz) / (h - 1) - 1.0
    return torch.stack([xnorm, ynorm], dim=-1)


def view_synthesis(ref_image: torch.Tensor, depth: torch.Tensor, ref_cam,
                   cam, padding_mode: str = "zeros") -> torch.Tensor:
    """Warp NHWC ``ref_image`` [B, H, W, C] into ``cam``'s view given its
    depth [B, H, W, 1]."""
    if depth.shape[-1] != 1:
        raise ValueError(f"depth must be [B,H,W,1], got {tuple(depth.shape)}")
    return grid_sample(ref_image, synthesis_coords(depth, ref_cam, cam),
                       padding_mode)


def view_synthesis_planar(ref_image: torch.Tensor, depth: torch.Tensor,
                          ref_cam, cam,
                          padding_mode: str = "zeros") -> torch.Tensor:
    """``view_synthesis`` for a planar reference image [B, C, H, W];
    returns the warped image planar."""
    if depth.shape[-1] != 1:
        raise ValueError(f"depth must be [B,H,W,1], got {tuple(depth.shape)}")
    return grid_sample_planar(
        ref_image, synthesis_coords(depth, ref_cam, cam), padding_mode)
