"""Bilinear warp of the view synthesis: the sampled value and its spatial
derivative fields.

``warp_bilinear`` launches the hand-written CUDA kernel ``csrc/warp.cu``
(it replaces the TPU kernel ``mgnet_tpu/ops/pallas/warp.py:297-485``,
``warp_bilinear_banded``; the source states its bound and design).
``warp_bilinear_reference`` is the plain PyTorch version of the same
function, a transcription of ``_grid_sample_core``
(``mgnet_tpu/geometry/image.py:166-243``) on a channel-planar image: the
wrapper uses it for CPU tensors, and tests and ``chip_smoke.py`` hold the
kernel against it. A CUDA tensor always goes to the kernel; anything the
kernel does not take raises. The wrapper reaches both through the custom
op ``mgnet::warp_bilinear`` (``warp_bilinear_op``), so that
``torch.compile`` and ``torch.export`` see the kernel as one opaque call.

Both take a planar image [B, C, H, W] and normalized coords
[B, H', W', 2] in (x, y) order, sample with torch's ``grid_sample``
contract (bilinear, zeros padding per corner, align_corners=True), and
return ``(out, gx, gy)``, each [B, C, H', W']: ``gx``, ``gy`` are
d(out)/d(coord_x), d(out)/d(coord_y), already scaled by (W-1)/2 and
(H-1)/2. With ``with_grads=False`` they are None. The plain version also
takes ``padding_mode="border"`` (clipped corners, no masks), which has no
kernel: ``geometry/image.py`` uses it for CPU tensors only.
"""

from __future__ import annotations

import torch

from mgnet_tpu_torch.ops._build import load_library

__all__ = ["warp_bilinear", "warp_bilinear_op", "warp_bilinear_reference"]

_MAX_BATCH = 65535  # gridDim.y


def warp_bilinear_reference(image: torch.Tensor, coords: torch.Tensor,
                            with_grads: bool = True,
                            padding_mode: str = "zeros"):
    """Plain PyTorch version, operation by operation as the kernel."""
    b, c, h, w = image.shape
    _, oh, ow, _ = coords.shape
    x = (coords[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    def clip(v, n):
        return torch.clamp(v, 0, n - 1).long()

    def inside(v, n):
        return (v >= 0) & (v <= n - 1)

    flat = image.reshape(b, c, h * w)

    def corner(yv, xv):
        idx = (clip(yv, h) * w + clip(xv, w)).reshape(b, 1, oh * ow)
        v = torch.gather(flat, 2, idx.expand(b, c, oh * ow))
        v = v.reshape(b, c, oh, ow)
        if padding_mode == "border":
            return v
        mask = (inside(yv, h) & inside(xv, w))[:, None]
        return torch.where(mask, v, torch.zeros((), dtype=v.dtype,
                                                device=v.device))

    v00, v01 = corner(y0, x0), corner(y0, x1)
    v10, v11 = corner(y1, x0), corner(y1, x1)
    wy0_, wy1_ = wy0[:, None], wy1[:, None]
    wx0_, wx1_ = wx0[:, None], wx1[:, None]
    out = (v00 * (wy0_ * wx0_) + v01 * (wy0_ * wx1_)
           + v10 * (wy1_ * wx0_) + v11 * (wy1_ * wx1_))
    if not with_grads:
        return out, None, None
    gx = (wy0_ * (v01 - v00) + wy1_ * (v11 - v10)) * ((w - 1) * 0.5)
    gy = (wx0_ * (v10 - v00) + wx1_ * (v11 - v01)) * ((h - 1) * 0.5)
    return out, gx, gy


def _check(image, coords) -> None:
    if image.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError(f"warp_bilinear: image and coords must be float32, "
                        f"got {image.dtype}, {coords.dtype}")
    if image.device != coords.device:
        raise ValueError(f"warp_bilinear: image on {image.device}, coords "
                         f"on {coords.device}")
    if image.dim() != 4 or coords.dim() != 4 or coords.shape[-1] != 2 \
            or coords.shape[0] != image.shape[0]:
        raise ValueError(
            f"warp_bilinear: image must be [B, C, H, W] and coords "
            f"[B, H', W', 2], got {tuple(image.shape)}, "
            f"{tuple(coords.shape)}")


def _launch(image, coords, with_grads: bool):
    """Launch the kernel on CUDA tensors (one count in
    ``warp_bilinear.launches``); anything it does not take raises. Without
    grads, gx and gy are empty [0] tensors (the op returns no None)."""
    if image.device.type != "cuda":
        raise ValueError(f"warp_bilinear: unsupported device {image.device}")
    b, c, h, w = image.shape
    _, oh, ow, _ = coords.shape
    if b > _MAX_BATCH:
        raise ValueError(f"warp_bilinear: batch {b} > {_MAX_BATCH}")
    if not (image.is_contiguous() and coords.is_contiguous()):
        raise ValueError("warp_bilinear: image and coords must be "
                         "contiguous")
    lib = load_library()
    out = torch.empty((b, c, oh, ow), dtype=torch.float32,
                      device=image.device)
    gx = torch.empty_like(out) if with_grads else out.new_empty(0)
    gy = torch.empty_like(out) if with_grads else out.new_empty(0)
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        rc = lib.mgnet_warp_bilinear(
            image.data_ptr(), coords.data_ptr(), out.data_ptr(),
            gx.data_ptr() if with_grads else None,
            gy.data_ptr() if with_grads else None,
            b, c, h, w, oh * ow, stream)
    if rc != 0:
        raise RuntimeError(f"warp_bilinear: kernel launch failed "
                           f"(cudaError {rc})")
    warp_bilinear.launches += 1
    return out, gx, gy


# The op ``mgnet::warp_bilinear``: its CPU kernel is the plain version, its
# CUDA kernel the hand-written one, its fake gives the shapes for
# torch.export and torch.compile. Without grads it returns gx and gy as
# empty [0] tensors.
@torch.library.custom_op("mgnet::warp_bilinear", mutates_args=(),
                         device_types="cpu")
def warp_bilinear_op(image: torch.Tensor, coords: torch.Tensor,
                     with_grads: bool
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    out, gx, gy = warp_bilinear_reference(image, coords, with_grads)
    if not with_grads:
        gx, gy = out.new_empty(0), out.new_empty(0)
    return out, gx, gy


@warp_bilinear_op.register_kernel("cuda")
def _warp_bilinear_cuda(image, coords, with_grads):
    return _launch(image, coords, with_grads)


@warp_bilinear_op.register_fake
def _warp_bilinear_fake(image, coords, with_grads):
    b, c = image.shape[:2]
    out = image.new_empty((b, c, coords.shape[1], coords.shape[2]))
    if not with_grads:
        return out, image.new_empty(0), image.new_empty(0)
    return out, torch.empty_like(out), torch.empty_like(out)


def warp_bilinear(image: torch.Tensor, coords: torch.Tensor,
                  with_grads: bool = True):
    """Sample planar ``image`` at normalized ``coords``.

    Calls ``mgnet::warp_bilinear``: CUDA tensors launch the kernel (and
    count one launch in ``warp_bilinear.launches``); CPU tensors take
    ``warp_bilinear_reference``.
    """
    _check(image, coords)
    out, gx, gy = warp_bilinear_op(image, coords, with_grads)
    return (out, gx, gy) if with_grads else (out, None, None)


warp_bilinear.launches = 0
