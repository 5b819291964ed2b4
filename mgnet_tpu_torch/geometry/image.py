"""Image-space helpers: pixel grid and resizes.

Port of ``mgnet_tpu/geometry/image.py:37-157``. ``interpolate_bilinear``
takes NHWC and ``interpolate_bilinear_cf`` NCHW, as in the JAX package;
both follow torch's ``align_corners=True`` contract, which the JAX package
evaluates as dense interpolation matrices and this port with
``F.interpolate``. ``interpolate_nearest`` runs inside the NCHW modules and
takes NCHW.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "image_grid",
    "interpolate_bilinear",
    "interpolate_bilinear_cf",
    "interpolate_nearest",
]


def image_grid(batch: int, height: int, width: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel grid [B, H, W, 3] with channels (x, y, 1)."""
    xs = torch.arange(width, dtype=dtype, device=device)
    ys = torch.arange(height, dtype=dtype, device=device)
    grid = torch.stack([
        xs[None, :].expand(height, width),
        ys[:, None].expand(height, width),
        torch.ones(height, width, dtype=dtype, device=device),
    ], dim=-1)
    return grid[None].expand(batch, height, width, 3)


def interpolate_bilinear_cf(x: torch.Tensor,
                            size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear align-corners resize of NCHW; returns float32, like the JAX
    function of the same name."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x.float(), size=tuple(size), mode="bilinear",
                         align_corners=True)


def interpolate_bilinear(x: torch.Tensor,
                         size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear align-corners resize of NHWC, computed in float32 and cast
    back to the input dtype."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = interpolate_bilinear_cf(x.permute(0, 3, 1, 2), size)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def interpolate_nearest(x: torch.Tensor,
                        size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NCHW with src = floor(dst * in / out) in integer
    arithmetic, as the JAX function (torch's float scale can round
    differently)."""
    out_h, out_w = size
    in_h, in_w = x.shape[2:]
    if (in_h, in_w) == (out_h, out_w):
        return x
    idx_h = torch.arange(out_h, device=x.device) * in_h // out_h
    idx_w = torch.arange(out_w, device=x.device) * in_w // out_w
    return x[:, :, idx_h][:, :, :, idx_w]
