"""Pinhole camera over NHWC maps.

Port of ``Camera(K).Kinv`` and ``reconstruct(frame="c")`` from
``mgnet_tpu/geometry/camera.py:21-104``. The JAX package evaluates the
ray product at ``Precision.HIGHEST`` (full f32). Here it is written out
element-wise in f32, so it involves no matmul and its result does not
depend on ``torch.backends.cuda.matmul.allow_tf32`` or
``torch.backends.cudnn.allow_tf32``.
"""

from __future__ import annotations

import torch

from mgnet_tpu_torch.geometry.image import image_grid

__all__ = ["Camera"]


class Camera:
    """Pinhole camera with intrinsics K [B, 3, 3] (camera frame only)."""

    def __init__(self, K: torch.Tensor):
        self.K = K[None] if K.dim() == 2 else K

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

    def reconstruct(self, depth: torch.Tensor,
                    frame: str = "c") -> torch.Tensor:
        """Unproject depth [B, H, W, 1] to camera-frame points [B, H, W, 3]."""
        if frame != "c":
            raise ValueError(f"Only the camera frame is ported, got {frame}")
        b, h, w, c = depth.shape
        if c != 1:
            raise ValueError(f"depth must be [B,H,W,1], got {tuple(depth.shape)}")
        grid = image_grid(b, h, w, dtype=depth.dtype, device=depth.device)
        kinv = self.Kinv.to(depth.dtype)[:, None, None]      # [B,1,1,3,3]
        rays = (kinv[..., 0] * grid[..., 0:1]
                + kinv[..., 1] * grid[..., 1:2]
                + kinv[..., 2] * grid[..., 2:3])             # [B,H,W,3]
        return rays * depth
