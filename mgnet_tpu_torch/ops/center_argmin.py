"""Nearest valid instance center per pixel: the clustering step of
panoptic fusion.

``center_argmin`` launches the hand-written CUDA kernel
``csrc/center_argmin.cu`` (it replaces the TPU kernel
``mgnet_tpu/ops/pallas/center_argmin.py:63-133``; the source states its
bound and design). ``center_argmin_reference`` is the plain PyTorch
version of the same function: the wrapper uses it for CPU tensors, and
tests and ``chip_smoke.py`` hold the kernel against it. A CUDA tensor
always goes to the kernel; anything the kernel does not take raises.

Both compute, for pixel (py, px) and centers k,

    argmin_k  c2_k - 2 * (py * cy_k + px * cx_k)

the expanded form of argmin_k |p - c_k|^2, with a running (best, index)
pair and a strict ``<``, so ties go to the lowest k. ``center_inputs``
turns (centers, valid) into (cy, cx, c2) as the TPU wrapper does: invalid
centers become the 1e12 sentinel and c2 is clamped to 1e30.
"""

from __future__ import annotations

import torch

from mgnet_tpu_torch.ops._build import load_library

__all__ = ["center_argmin", "center_argmin_reference", "center_inputs",
           "MAX_CENTERS"]

# 3 x K f32 centers must fit the default 48 KB of shared memory a block
MAX_CENTERS = 4096
_MAX_BATCH = 65535  # gridDim.z


def center_inputs(centers_yx: torch.Tensor, valid: torch.Tensor):
    """[B, K, 2] centers + [B, K] validity -> (cy, cx, c2), each [B, K]
    f32 contiguous (reference: ops/pallas/center_argmin.py:150-157)."""
    cs = torch.where(valid[..., None], centers_yx.float(), 1e12)
    cy = cs[..., 0].contiguous()
    cx = cs[..., 1].contiguous()
    c2 = torch.clamp(cy * cy + cx * cx, max=1e30)
    return cy, cx, c2


def center_argmin_reference(py, px, cy, cx, c2) -> torch.Tensor:
    """Plain PyTorch version: py, px [B, H, W] f32; cy, cx, c2 [B, K] f32
    -> [B, H, W] int32. Same arithmetic, in the same order, as the kernel."""
    best = torch.full_like(py, float("inf"))
    besti = torch.zeros(py.shape, dtype=torch.int32, device=py.device)
    for i in range(cy.shape[1]):
        cyi = cy[:, i, None, None]
        cxi = cx[:, i, None, None]
        c2i = c2[:, i, None, None]
        score = c2i - 2.0 * (py * cyi + px * cxi)
        pred = score < best
        best = torch.where(pred, score, best)
        besti.masked_fill_(pred, i)
    return besti


def _check(py, px, cy, cx, c2) -> None:
    tensors = dict(py=py, px=px, cy=cy, cx=cx, c2=c2)
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"center_argmin: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != py.device:
            raise ValueError(f"center_argmin: {name} is on {t.device}, "
                             f"py on {py.device}")
    if py.dim() != 3 or px.shape != py.shape:
        raise ValueError(f"center_argmin: py, px must be one [B, H, W] "
                         f"shape, got {tuple(py.shape)}, {tuple(px.shape)}")
    b = py.shape[0]
    if cy.dim() != 2 or cy.shape[0] != b or cx.shape != cy.shape \
            or c2.shape != cy.shape:
        raise ValueError(
            f"center_argmin: cy, cx, c2 must be [B={b}, K], got "
            f"{tuple(cy.shape)}, {tuple(cx.shape)}, {tuple(c2.shape)}")


def center_argmin(py, px, cy, cx, c2) -> torch.Tensor:
    """Nearest center index per pixel.

    Args:
        py, px: [B, H, W] f32 target coordinates (pixel + offset).
        cy, cx, c2: [B, K] f32 from ``center_inputs``.

    Returns:
        [B, H, W] int32 indices in [0, K).

    CUDA tensors launch the kernel (and count one launch in
    ``center_argmin.launches``); CPU tensors take
    ``center_argmin_reference``.
    """
    _check(py, px, cy, cx, c2)
    if py.device.type == "cpu":
        return center_argmin_reference(py, px, cy, cx, c2)
    if py.device.type != "cuda":
        raise ValueError(f"center_argmin: unsupported device {py.device}")
    b, h, w = py.shape
    k = cy.shape[1]
    if not 1 <= k <= MAX_CENTERS:
        raise ValueError(f"center_argmin: K={k} outside [1, {MAX_CENTERS}]")
    if b > _MAX_BATCH:
        raise ValueError(f"center_argmin: batch {b} > {_MAX_BATCH}")
    for name, t in dict(py=py, px=px, cy=cy, cx=cx, c2=c2).items():
        if not t.is_contiguous():
            raise ValueError(f"center_argmin: {name} must be contiguous")
    lib = load_library()
    out = torch.empty((b, h, w), dtype=torch.int32, device=py.device)
    with torch.cuda.device(py.device):
        stream = torch.cuda.current_stream(py.device).cuda_stream
        rc = lib.mgnet_center_argmin(
            py.data_ptr(), px.data_ptr(), cy.data_ptr(), cx.data_ptr(),
            c2.data_ptr(), out.data_ptr(), b, h * w, k, stream)
    if rc != 0:
        raise RuntimeError(f"center_argmin: kernel launch failed "
                           f"(cudaError {rc})")
    center_argmin.launches += 1
    return out


center_argmin.launches = 0
