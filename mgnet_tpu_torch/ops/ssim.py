"""Fused SSIM + L1 photometric residual, forward and backward.

``ssim_residual_fwd`` and ``ssim_residual_bwd`` launch the hand-written
CUDA kernels of ``csrc/ssim.cu`` (they replace the TPU kernels of
``mgnet_tpu/ops/pallas/ssim.py``: ``_residual_batched`` and
``_bwd_batched``; the source states their bounds and design).
``ssim_residual_reference`` and ``ssim_residual_bwd_reference`` are the
plain PyTorch versions: the wrappers use them for CPU tensors, and tests
and ``chip_smoke.py`` hold the kernels against them. A CUDA tensor always
goes to a kernel; anything a kernel does not take raises. The wrappers
reach both through the custom ops ``mgnet::ssim_residual_fwd`` and
``mgnet::ssim_residual_bwd`` (``ssim_residual_fwd_op``,
``ssim_residual_bwd_op``), so that ``torch.compile`` and ``torch.export``
see each kernel as one opaque call.

The residual of planar x, y [B, C, H, W] is [B, H, W]:

    (1/C) sum_c  w * clamp((1 - SSIM_c) / 2, 0, 1) + (1 - w) * |x_c - y_c|

with 3x3 mean-pool SSIM statistics over reflect-padded planes (c1=1e-4,
c2=9e-4), the planar form of ``mgnet_tpu/losses/photometric.py:114-126``.
Its backward is the closed form of ``mgnet_tpu/ops/pallas/ssim.py:
173-195`` (cotangents of the pooled statistics, the transposed pool in
reflect-padded space, then the fold of the padding). Both plain versions
divide by 9 and by C as a multiplication by the f32 reciprocal (as
PyTorch's CUDA division by a scalar does), so that CPU, card and kernel
compute one function.

``fused_photometric_residual`` is the differentiable entry point: a
``torch.autograd.Function`` whose forward is the forward op and whose
backward is the backward op.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mgnet_tpu_torch.ops._build import load_library

__all__ = [
    "SSIM_C1",
    "SSIM_C2",
    "fused_photometric_residual",
    "ssim_residual_bwd",
    "ssim_residual_bwd_op",
    "ssim_residual_bwd_reference",
    "ssim_residual_fwd",
    "ssim_residual_fwd_op",
    "ssim_residual_reference",
]

SSIM_C1 = 1e-4
SSIM_C2 = 9e-4
_INV9 = 1.0 / 9.0
_MAX_PLANES = 65535  # gridDim.z: the forward's B, the backward's B x C


def _pad(v: torch.Tensor) -> torch.Tensor:
    return F.pad(v, (1, 1, 1, 1), mode="reflect")


def _pool3(v: torch.Tensor) -> torch.Tensor:
    """3x3 'valid' mean pool of padded [B, C, H+2, W+2]: row sums, then
    column sums (mgnet_tpu/losses/photometric.py:_avg_pool3_planar)."""
    r = v[:, :, :-2] + v[:, :, 1:-1] + v[:, :, 2:]
    s = r[..., :-2] + r[..., 1:-1] + r[..., 2:]
    return s * _INV9


def _channel_mean(res: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H, W], summing the channels in order."""
    acc = res[:, 0]
    for k in range(1, res.shape[1]):
        acc = acc + res[:, k]
    return acc * (1.0 / res.shape[1])


def ssim_residual_reference(x: torch.Tensor, y: torch.Tensor,
                            ssim_weight: float = 0.85,
                            c1: float = SSIM_C1,
                            c2: float = SSIM_C2) -> torch.Tensor:
    """Plain PyTorch forward: x, y [B, C, H, W] f32 -> [B, H, W]."""
    xp, yp = _pad(x), _pad(y)
    mu_x, mu_y = _pool3(xp), _pool3(yp)
    mu_xy = mu_x * mu_y
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    sigma_x = _pool3(xp * xp) - mu_xx
    sigma_y = _pool3(yp * yp) - mu_yy
    sigma_xy = _pool3(xp * yp) - mu_xy
    ssim_val = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2))
    s = torch.clamp((1.0 - ssim_val) / 2.0, 0.0, 1.0)
    res = ssim_weight * s + (1.0 - ssim_weight) * torch.abs(x - y)
    return _channel_mean(res)


def _pool3_seq(v: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """3x3 'valid' mean pool summing the 9 window entries one by one,
    row-major (the order of the TPU backward kernel, ssim.py:243-249)."""
    acc = None
    for dy in range(3):
        for dx in range(3):
            sl = v[:, :, dy:dy + h, dx:dx + w]
            acc = sl if acc is None else acc + sl
    return acc * _INV9


def _pool3_transpose(q: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """P^T of the 3x3 mean pool: q [B, C, H, W] at the statistics' sites
    -> [B, C, H+2, W+2] in padded space (ssim.py:269-276)."""
    qp = F.pad(q, (2, 2, 2, 2))
    rs = (qp[:, :, 0:h + 2] + qp[:, :, 1:h + 3] + qp[:, :, 2:h + 4]) * _INV9
    return rs[..., 0:w + 2] + rs[..., 1:w + 3] + rs[..., 2:w + 4]


def _fold_reflect(d: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Transpose of the 1-pixel reflect pad: padded row/col 0 adds onto 2,
    H+1 onto H-1 (W+1 onto W-1); returns the interior (ssim.py:393-403)."""
    d = d.clone()
    d[:, :, 2] += d[:, :, 0]
    d[:, :, h - 1] += d[:, :, h + 1]
    d[:, :, :, 2] += d[:, :, :, 0]
    d[:, :, :, w - 1] += d[:, :, :, w + 1]
    return d[:, :, 1:h + 1, 1:w + 1]


def ssim_residual_bwd_reference(x: torch.Tensor, y: torch.Tensor,
                                g: torch.Tensor, ssim_weight: float = 0.85,
                                c1: float = SSIM_C1, c2: float = SSIM_C2):
    """Plain PyTorch backward: x, y [B, C, H, W], g [B, H, W] -> (dx, dy),
    the closed form of the TPU backward kernel."""
    _, c, h, w = x.shape
    xp, yp = _pad(x), _pad(y)
    mu_x = _pool3_seq(xp, h, w)
    mu_y = _pool3_seq(yp, h, w)
    pxx = _pool3_seq(xp * xp, h, w)
    pyy = _pool3_seq(yp * yp, h, w)
    pxy = _pool3_seq(xp * yp, h, w)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    a = 2.0 * mu_xy + c1
    bb = 2.0 * (pxy - mu_xy) + c2
    cd = mu_xx + mu_yy + c1
    d = (pxx - mu_xx) + (pyy - mu_yy) + c2
    inv_cdd = 1.0 / (cd * d)
    v = a * bb * inv_cdd
    loss_half = (1.0 - v) * 0.5
    active = (loss_half > 0.0) & (loss_half < 1.0)
    gc = g[:, None] * (1.0 / c)
    gv = torch.where(active, (-0.5 * ssim_weight) * gc,
                     torch.zeros((), dtype=gc.dtype, device=gc.device))
    ga = gv * bb * inv_cdd
    gb2 = gv * a * inv_cdd
    gcd = -(gv * v) / cd
    gd = -(gv * v) / d
    gab = ga - gb2
    gcdd = gcd - gd
    t_mu_x = _pool3_transpose(2.0 * (mu_y * gab + mu_x * gcdd), h, w)
    t_mu_y = _pool3_transpose(2.0 * (mu_x * gab + mu_y * gcdd), h, w)
    t_xx = _pool3_transpose(gd, h, w)
    t_xy = _pool3_transpose(2.0 * gb2, h, w)
    gpad = F.pad(g, (1, 1, 1, 1))[:, None]
    l1 = ((1.0 - ssim_weight) / c) * gpad * torch.sign(xp - yp)
    dx = t_mu_x + 2.0 * xp * t_xx + yp * t_xy + l1
    dy = t_mu_y + 2.0 * yp * t_xx + xp * t_xy - l1
    return _fold_reflect(dx, h, w), _fold_reflect(dy, h, w)


def _check(name, *tensors, shape=None) -> None:
    x = tensors[0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: inputs must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: inputs on {t.device} and {x.device}")
    if x.dim() != 4 or tensors[1].shape != x.shape:
        raise ValueError(f"{name}: x, y must be one [B, C, H, W] shape, got "
                         f"{tuple(x.shape)}, {tuple(tensors[1].shape)}")
    if min(x.shape[2:]) < 2:
        raise ValueError(f"{name}: reflect padding needs H, W >= 2, got "
                         f"{tuple(x.shape)}")
    if shape is not None and tuple(tensors[2].shape) != shape:
        raise ValueError(f"{name}: g must be {shape}, got "
                         f"{tuple(tensors[2].shape)}")


def _launch_ready(name, tensors, planes) -> ctypes.CDLL:
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if planes > _MAX_PLANES:
        raise ValueError(f"{name}: {planes} planes on the grid's z axis > "
                         f"{_MAX_PLANES}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return load_library()


def _f32(v: float) -> ctypes.c_float:
    return ctypes.c_float(v)


def _launch_fwd(x, y, ssim_weight: float) -> torch.Tensor:
    lib = _launch_ready("ssim_residual_fwd", (x, y), x.shape[0])
    b, c, h, w = x.shape
    out = torch.empty((b, h, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mgnet_ssim_residual_fwd(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), b, c, h, w,
            _f32(SSIM_C1), _f32(SSIM_C2), _f32(ssim_weight),
            _f32(1.0 - ssim_weight), _f32(_INV9), _f32(1.0 / c), stream)
    if rc != 0:
        raise RuntimeError(f"ssim_residual_fwd: kernel launch failed "
                           f"(cudaError {rc})")
    ssim_residual_fwd.launches += 1
    return out


def _launch_bwd(x, y, g, ssim_weight: float):
    b, c, h, w = x.shape
    lib = _launch_ready("ssim_residual_bwd", (x, y, g), b * c)
    dx = torch.empty_like(x)
    dy = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mgnet_ssim_residual_bwd(
            x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dy.data_ptr(), b, c, h, w, _f32(SSIM_C1), _f32(SSIM_C2),
            _f32(_INV9), _f32(1.0 / c), _f32(-0.5 * ssim_weight),
            _f32((1.0 - ssim_weight) / c), stream)
    if rc != 0:
        raise RuntimeError(f"ssim_residual_bwd: kernel launch failed "
                           f"(cudaError {rc})")
    ssim_residual_bwd.launches += 1
    return dx, dy


# The ops ``mgnet::ssim_residual_fwd`` and ``mgnet::ssim_residual_bwd``:
# CPU kernels are the plain versions, CUDA kernels the hand-written ones,
# fakes give the shapes for torch.export and torch.compile.
@torch.library.custom_op("mgnet::ssim_residual_fwd", mutates_args=(),
                         device_types="cpu")
def ssim_residual_fwd_op(x: torch.Tensor, y: torch.Tensor,
                         ssim_weight: float) -> torch.Tensor:
    return ssim_residual_reference(x, y, ssim_weight)


@ssim_residual_fwd_op.register_kernel("cuda")
def _ssim_residual_fwd_cuda(x, y, ssim_weight):
    return _launch_fwd(x, y, ssim_weight)


@ssim_residual_fwd_op.register_fake
def _ssim_residual_fwd_fake(x, y, ssim_weight):
    b, _, h, w = x.shape
    return x.new_empty((b, h, w))


@torch.library.custom_op("mgnet::ssim_residual_bwd", mutates_args=(),
                         device_types="cpu")
def ssim_residual_bwd_op(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                         ssim_weight: float
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    # contiguous, as the kernel's outputs and the fake's are (the plain
    # version returns views of the padded planes)
    dx, dy = ssim_residual_bwd_reference(x, y, g, ssim_weight)
    return dx.contiguous(), dy.contiguous()


@ssim_residual_bwd_op.register_kernel("cuda")
def _ssim_residual_bwd_cuda(x, y, g, ssim_weight):
    return _launch_bwd(x, y, g, ssim_weight)


@ssim_residual_bwd_op.register_fake
def _ssim_residual_bwd_fake(x, y, g, ssim_weight):
    return torch.empty_like(x), torch.empty_like(x)


def ssim_residual_fwd(x: torch.Tensor, y: torch.Tensor,
                      ssim_weight: float = 0.85) -> torch.Tensor:
    """Residual [B, H, W] of planar x, y [B, C, H, W].

    Calls ``mgnet::ssim_residual_fwd``: CUDA tensors launch the forward
    kernel (one count in ``ssim_residual_fwd.launches``); CPU tensors take
    ``ssim_residual_reference``.
    """
    _check("ssim_residual_fwd", x, y)
    return ssim_residual_fwd_op(x, y, ssim_weight)


def ssim_residual_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                      ssim_weight: float = 0.85):
    """(dx, dy) [B, C, H, W] of the residual, given its cotangent g
    [B, H, W].

    Calls ``mgnet::ssim_residual_bwd``: CUDA tensors launch the backward
    kernel (one count in ``ssim_residual_bwd.launches``); CPU tensors take
    ``ssim_residual_bwd_reference``.
    """
    b, c, h, w = x.shape
    _check("ssim_residual_bwd", x, y, g, shape=(b, h, w))
    return ssim_residual_bwd_op(x, y, g, ssim_weight)


ssim_residual_fwd.launches = 0
ssim_residual_bwd.launches = 0


class _FusedResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, warped, image, ssim_weight):
        ctx.ssim_weight = ssim_weight
        ctx.save_for_backward(warped, image)
        return ssim_residual_fwd(warped, image, ssim_weight)

    @staticmethod
    def backward(ctx, g):
        warped, image = ctx.saved_tensors
        dx, dy = ssim_residual_bwd(warped, image, g.contiguous(),
                                   ctx.ssim_weight)
        return (dx if ctx.needs_input_grad[0] else None,
                dy if ctx.needs_input_grad[1] else None, None)


def fused_photometric_residual(warped: torch.Tensor, image: torch.Tensor,
                               ssim_weight: float = 0.85) -> torch.Tensor:
    """Differentiable residual [B, H, W] of planar ``warped`` against
    ``image`` (both [B, C, H, W], cast to contiguous float32)."""
    return _FusedResidual.apply(warped.float().contiguous(),
                                image.float().contiguous(), ssim_weight)
