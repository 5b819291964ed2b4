"""Pinhole camera over NHWC maps, with a camera-to-world pose.

Port of ``Camera`` from ``mgnet_tpu/geometry/camera.py``: closed-form
``Kinv``, ``scaled``, ``reconstruct`` and ``project`` in the camera or the
world frame. The JAX package evaluates the ray and projection products at
``Precision.HIGHEST`` (full f32). Here they are written out element-wise
in f32, so they involve no matmul and their results do not depend on
``torch.backends.cuda.matmul.allow_tf32`` or
``torch.backends.cudnn.allow_tf32``.
"""

from __future__ import annotations

from typing import Optional

import torch

from mgnet_tpu_torch.geometry.image import image_grid
from mgnet_tpu_torch.geometry.pose import Pose

__all__ = ["Camera"]


def _apply3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-batch [B, 3, 3] applied to NHWC 3-vectors [B, H, W, 3]."""
    m = m[:, None, None]                                  # [B,1,1,3,3]
    return (m[..., 0] * v[..., 0:1] + m[..., 1] * v[..., 1:2]
            + m[..., 2] * v[..., 2:3])


class Camera:
    """Pinhole camera: intrinsics K [B, 3, 3] and the world-to-camera pose
    ``Tcw`` (identity when not given)."""

    def __init__(self, K: torch.Tensor, Tcw: Optional[Pose] = None):
        self.K = K[None] if K.dim() == 2 else K
        self.Tcw = (Pose.identity(self.K.shape[0], self.K.dtype,
                                  self.K.device) if Tcw is None else Tcw)

    def __len__(self) -> int:
        return self.K.shape[0]

    @property
    def Twc(self) -> Pose:
        return self.Tcw.inverse()

    @property
    def Kinv(self) -> torch.Tensor:
        """Closed-form inverse intrinsics."""
        K = self.K
        fx, fy, cx, cy = K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]
        zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
        row0 = torch.stack([1.0 / fx, zeros, -cx / fx], dim=1)
        row1 = torch.stack([zeros, 1.0 / fy, -cy / fy], dim=1)
        row2 = torch.stack([zeros, zeros, ones], dim=1)
        return torch.stack([row0, row1, row2], dim=1)

    def scaled(self, x_scale: float,
               y_scale: Optional[float] = None) -> "Camera":
        """Camera for an image resized by (x_scale, y_scale)."""
        from mgnet_tpu_torch.geometry.camera_utils import scale_intrinsics

        if y_scale is None:
            y_scale = x_scale
        if x_scale == 1.0 and y_scale == 1.0:
            return self
        return Camera(scale_intrinsics(self.K, x_scale, y_scale),
                      Tcw=self.Tcw)

    def reconstruct(self, depth: torch.Tensor,
                    frame: str = "w") -> torch.Tensor:
        """Unproject depth [B, H, W, 1] to points [B, H, W, 3] in the
        camera ("c") or world ("w") frame."""
        b, h, w, c = depth.shape
        if c != 1:
            raise ValueError(
                f"depth must be [B,H,W,1], got {tuple(depth.shape)}")
        grid = image_grid(b, h, w, dtype=depth.dtype, device=depth.device)
        xc = _apply3(self.Kinv.to(depth.dtype), grid) * depth
        if frame == "c":
            return xc
        if frame == "w":
            return self.Twc @ xc
        raise ValueError(f"Unknown reference frame {frame}")

    def project(self, points: torch.Tensor, frame: str = "w") -> torch.Tensor:
        """Project points [B, H, W, 3] to normalized (x, y) coords in
        [-1, 1] (the grid_sample convention), [B, H, W, 2]."""
        b, h, w, c = points.shape
        if c != 3:
            raise ValueError(
                f"points must be [B,H,W,3], got {tuple(points.shape)}")
        if frame == "w":
            points = self.Tcw @ points
        elif frame != "c":
            raise ValueError(f"Unknown reference frame {frame}")
        proj = _apply3(self.K.to(points.dtype), points)
        x, y = proj[..., 0], proj[..., 1]
        z = torch.clamp(proj[..., 2], min=1e-5)
        xnorm = 2.0 * (x / z) / (w - 1) - 1.0
        ynorm = 2.0 * (y / z) / (h - 1) - 1.0
        return torch.stack([xnorm, ynorm], dim=-1)
