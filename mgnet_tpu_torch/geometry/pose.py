"""SE(3) pose math over [B, 4, 4] tensors.

Port of ``mgnet_tpu/geometry/pose.py``: XYZ Euler angles to rotations,
6-DoF vectors to transforms, the closed-form inverse, and ``Pose``
(composition with ``@`` and the transform of NHWC point maps). The point
transform is written out element-wise in f32, like ``Camera`` (the JAX
package evaluates it at ``Precision.HIGHEST``), so it does not depend on
the TF32 switches.
"""

from __future__ import annotations

import torch

__all__ = ["euler2mat", "pose_vec2mat", "invert_pose", "Pose"]


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """XYZ Euler angles [B, 3] -> rotations [B, 3, 3], R = Rx @ Ry @ Rz."""
    x, y, z = angle[:, 0], angle[:, 1], angle[:, 2]
    b = angle.shape[0]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    cz, sz = torch.cos(z), torch.sin(z)
    zmat = torch.stack([cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones],
                       dim=1).reshape(b, 3, 3)
    cy, sy = torch.cos(y), torch.sin(y)
    ymat = torch.stack([cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy],
                       dim=1).reshape(b, 3, 3)
    cx, sx = torch.cos(x), torch.sin(x)
    xmat = torch.stack([ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx],
                       dim=1).reshape(b, 3, 3)
    return _matmul(_matmul(xmat, ymat), zmat)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, n, k] @ [B, k, m] as f32 multiply-adds (no TF32 matmul)."""
    return (a[:, :, :, None] * b[:, None, :, :]).sum(dim=2)


def pose_vec2mat(vec: torch.Tensor, mode: str = "euler") -> torch.Tensor:
    """[B, 6] (tx, ty, tz, rx, ry, rz) -> [B, 3, 4] transforms."""
    if mode != "euler":
        raise ValueError(f"Rotation mode not supported: {mode}")
    return torch.cat([euler2mat(vec[:, 3:]), vec[:, :3, None]], dim=2)


def _bottom(batch: int, like: torch.Tensor) -> torch.Tensor:
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=like.dtype,
                       device=like.device)
    return row[None, None, :].expand(batch, 1, 4)


def invert_pose(mat: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of rigid [B, 4, 4] transforms: (R^T, -R^T t)."""
    rot_t = mat[:, :3, :3].transpose(-2, -1)
    t = -_matmul(rot_t, mat[:, :3, 3:4])
    return torch.cat([torch.cat([rot_t, t], dim=2),
                      _bottom(mat.shape[0], mat)], dim=1)


class Pose:
    """[B, 4, 4] rigid transform."""

    def __init__(self, mat: torch.Tensor):
        self.mat = mat[None] if mat.dim() == 2 else mat

    @classmethod
    def identity(cls, batch: int = 1, dtype=torch.float32,
                 device=None) -> "Pose":
        eye = torch.eye(4, dtype=dtype, device=device)
        return cls(eye[None].expand(batch, 4, 4))

    @classmethod
    def from_vec(cls, vec: torch.Tensor, mode: str = "euler") -> "Pose":
        mat34 = pose_vec2mat(vec, mode)
        return cls(torch.cat([mat34, _bottom(vec.shape[0], vec)], dim=1))

    def __len__(self) -> int:
        return self.mat.shape[0]

    def inverse(self) -> "Pose":
        return Pose(invert_pose(self.mat))

    def transform_pose(self, other: "Pose") -> "Pose":
        return Pose(_matmul(self.mat, other.mat))

    def transform_points(self, points: torch.Tensor) -> torch.Tensor:
        """Transform NHWC point maps [B, H, W, 3]."""
        rot = self.mat[:, None, None, :3, :3]            # [B,1,1,3,3]
        t = self.mat[:, None, None, :3, 3]               # [B,1,1,3]
        return (rot * points[..., None, :]).sum(dim=-1) + t

    def __matmul__(self, other):
        if isinstance(other, Pose):
            return self.transform_pose(other)
        if isinstance(other, torch.Tensor) and other.dim() == 4 \
                and other.shape[-1] == 3:
            return self.transform_points(other)
        raise ValueError(f"Cannot apply Pose to {type(other)}")
