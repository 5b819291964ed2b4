"""Image-space helpers: pixel grid, resizes and the bilinear grid sample.

Port of ``mgnet_tpu/geometry/image.py:37-446``. ``interpolate_bilinear``
takes NHWC and ``interpolate_bilinear_cf`` NCHW, as in the JAX package;
both follow torch's ``align_corners=True`` contract, which the JAX package
evaluates as dense interpolation matrices and this port with
``F.interpolate``. ``interpolate_nearest`` runs inside the NCHW modules and
takes NCHW. ``gradient_x``, ``gradient_y`` and ``match_scales`` take NHWC,
as the JAX functions do.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from mgnet_tpu_torch.ops.warp import warp_bilinear, warp_bilinear_reference

__all__ = [
    "gradient_x",
    "gradient_y",
    "match_scales",
    "image_grid",
    "interpolate_bilinear",
    "interpolate_bilinear_cf",
    "interpolate_nearest",
    "grid_sample",
    "grid_sample_planar",
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


def gradient_x(image: torch.Tensor) -> torch.Tensor:
    """Forward difference along width: [B,H,W,C] -> [B,H,W-1,C]."""
    return image[:, :, :-1, :] - image[:, :, 1:, :]


def gradient_y(image: torch.Tensor) -> torch.Tensor:
    """Forward difference along height: [B,H,W,C] -> [B,H-1,W,C]."""
    return image[:, :-1, :, :] - image[:, 1:, :, :]


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


def match_scales(image: torch.Tensor, shapes):
    """``image`` [B,H,W,C] resized to each (H, W) of ``shapes`` (bilinear,
    align corners)."""
    return [interpolate_bilinear(image, s) for s in shapes]


def _sample(image, coords, padding_mode, with_grads):
    if padding_mode == "zeros":
        return warp_bilinear(image, coords, with_grads)
    if padding_mode != "border":
        raise ValueError(f"Unsupported padding_mode: {padding_mode}")
    if image.device.type != "cpu":
        raise ValueError("grid_sample: padding_mode='border' has no kernel; "
                         "the warp kernel takes zeros padding only")
    return warp_bilinear_reference(image, coords, with_grads, "border")


def _image_cotangent(g, coords, shape, padding_mode):
    """Scatter-add of g [B, C, H', W'] at the 4 corners of every sample:
    the gradient with respect to the planar image [B, C, H, W]
    (mgnet_tpu/geometry/image.py:316-364)."""
    b, c, h, w = shape
    x = (coords[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (h - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    dimg = torch.zeros((b, c, h * w), dtype=g.dtype, device=g.device)
    gf = g.reshape(b, c, -1)

    def scat(yv, xv, wgt):
        if padding_mode == "zeros":
            wgt = wgt * ((xv >= 0) & (xv <= w - 1)
                         & (yv >= 0) & (yv <= h - 1)).to(wgt.dtype)
        idx = (torch.clamp(yv, 0, h - 1).long() * w
               + torch.clamp(xv, 0, w - 1).long()).reshape(b, 1, -1)
        dimg.scatter_add_(2, idx.expand(b, c, idx.shape[-1]),
                          gf * wgt.reshape(b, 1, -1))

    scat(y0, x0, wy0 * wx0)
    scat(y0, x1, wy0 * wx1)
    scat(y1, x0, wy1 * wx0)
    scat(y1, x1, wy1 * wx1)
    return dimg.reshape(b, c, h, w)


class _GridSamplePlanar(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, coords, padding_mode):
        want = ctx.needs_input_grad[1]
        out, gx, gy = _sample(image, coords, padding_mode, want)
        ctx.padding_mode = padding_mode
        ctx.image_shape = tuple(image.shape)
        ctx.save_for_backward(gx, gy, coords)
        return out

    @staticmethod
    def backward(ctx, g):
        gx, gy, coords = ctx.saved_tensors
        dimage = dcoords = None
        if ctx.needs_input_grad[1]:
            dcoords = torch.stack([(g * gx).sum(dim=1), (g * gy).sum(dim=1)],
                                  dim=-1)
        if ctx.needs_input_grad[0]:
            dimage = _image_cotangent(g, coords, ctx.image_shape,
                                      ctx.padding_mode)
        return dimage, dcoords, None


def grid_sample_planar(image: torch.Tensor, coords: torch.Tensor,
                       padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample of planar ``image`` [B, C, H, W] (cast to contiguous
    f32) at normalized ``coords`` [B, H', W', 2] (x, y) -> [B, C, H', W']."""
    return _GridSamplePlanar.apply(image.float().contiguous(),
                                   coords.float().contiguous(), padding_mode)


def grid_sample(image: torch.Tensor, coords: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample of NHWC ``image`` [B, H, W, C] at normalized
    ``coords`` [B, H', W', 2] (x, y) -> [B, H', W', C]."""
    out = grid_sample_planar(image.permute(0, 3, 1, 2), coords, padding_mode)
    return out.permute(0, 2, 3, 1)
