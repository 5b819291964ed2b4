"""Nearest valid instance center per pixel: the clustering step of
panoptic fusion.

``center_argmin`` launches the hand-written CUDA kernel
``csrc/center_argmin.cu`` (it replaces the TPU kernel
``mgnet_tpu/ops/pallas/center_argmin.py:63-133``; the source states its
bound, design and the proof that its pruning is exact).
``center_argmin_reference`` is the plain PyTorch version of the same
function: the wrapper uses it for CPU tensors, and tests and
``chip_smoke.py`` hold the kernel against it. A CUDA tensor always goes to
the kernel; anything the kernel does not take raises. The wrapper reaches
both through the custom op ``mgnet::center_argmin`` (``center_argmin_op``:
CPU kernel the plain version, CUDA kernel the launch, a fake for
``torch.export``), so that the exported frame keeps the kernel as one
opaque call.

Both compute, for pixel (py, px) and centers k,

    argmin_k  c2_k - 2 * (py * cy_k + px * cx_k)

the expanded form of argmin_k |p - c_k|^2, with a running (best, index)
pair and a strict ``<``, so ties go to the lowest k. ``center_inputs``
turns (centers, valid) into (cy, cx, c2) as the TPU wrapper does: invalid
centers become the 1e12 sentinel and c2 is clamped to 1e30.

The kernel scans, for each ``TILE_H x TILE_W`` pixel tile, only the
centers that can win a pixel of it. ``center_candidates_reference`` is the
plain model of that rule (the same f64 formulas in the same order); tests
and ``chip_smoke.py`` use it, the main path does not.
"""

from __future__ import annotations

import torch

from mgnet_tpu_torch.ops._build import load_library

__all__ = ["center_argmin", "center_argmin_op", "center_argmin_reference",
           "center_inputs", "center_candidates_reference", "MAX_CENTERS",
           "TILE_H", "TILE_W"]

# the kernel walks the centers kThreads at a time, so K has no shared-memory
# limit; 4096 is the largest K it is tested at
MAX_CENTERS = 4096
_MAX_BATCH = 65535  # gridDim.z
_MAX_TILE_ROWS = 65535  # gridDim.y
# the kernel's pixel tile (CENTER_TILE_H, CENTER_TILE_W in the source)
TILE_H, TILE_W = 32, 32
# the rule's constants (csrc/center_argmin.cu: kMarginRel, kMarginAbs,
# kEligibleCap)
_MARGIN_REL = 2.0 ** -20
_MARGIN_ABS = 2.0 ** -140
_ELIGIBLE_CAP = 2.0 ** 120


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


def _tiles(t: torch.Tensor, tile_h: int, tile_w: int, fill: float):
    """[B, H, W] -> [B, nTy, nTx, tile_h * tile_w], padded with ``fill``."""
    b, h, w = t.shape
    nty, ntx = -(-h // tile_h), -(-w // tile_w)
    t = torch.nn.functional.pad(t, (0, ntx * tile_w - w, 0, nty * tile_h - h),
                                value=fill)
    t = t.reshape(b, nty, tile_h, ntx, tile_w).permute(0, 1, 3, 2, 4)
    return t.reshape(b, nty, ntx, tile_h * tile_w)


def center_candidates_reference(py, px, cy, cx, c2, tile_h: int = TILE_H,
                                tile_w: int = TILE_W) -> torch.Tensor:
    """The kernel's per-tile candidate rule, in plain PyTorch f64.

    py, px [B, H, W] f32; cy, cx, c2 [B, K] f32 -> [B, nTy, nTx, K] bool:
    True where the kernel scans center k for the ``tile_h x tile_w`` tile
    (ceil(H / tile_h) x ceil(W / tile_w) tiles, the last ones ragged). The
    formulas, their order and the proof that a dropped center can neither
    win nor tie a pixel of its tile are in csrc/center_argmin.cu.
    """
    inside = _tiles(torch.ones_like(py, dtype=torch.bool), tile_h, tile_w,
                    False)
    y = _tiles(py, tile_h, tile_w, 0.0)
    x = _tiles(px, tile_h, tile_w, 0.0)
    finite = (torch.isfinite(y) & torch.isfinite(x) | ~inside).all(-1)
    inf = float("inf")
    y0, y1, x0, x1 = (
        v.double()[..., None] for v in (
            torch.where(inside, y, inf).amin(-1),
            torch.where(inside, y, -inf).amax(-1),
            torch.where(inside, x, inf).amin(-1),
            torch.where(inside, x, -inf).amax(-1)))
    ay = torch.maximum(y0.abs(), y1.abs())
    ax = torch.maximum(x0.abs(), x1.abs())
    cyd, cxd, c2d = (t.double()[:, None, None, :] for t in (cy, cx, c2))
    t = c2d.abs() + 2.0 * (ay * cyd.abs() + ax * cxd.abs())
    eligible = (t <= _ELIGIBLE_CAP) & finite[..., None]
    m = t * _MARGIN_REL + _MARGIN_ABS
    dy = torch.maximum((y0 - cyd).abs(), (y1 - cyd).abs())
    dx = torch.maximum((x0 - cxd).abs(), (x1 - cxd).abs())
    delta = c2d - (cyd * cyd + cxd * cxd)
    hi = ((dy * dy + dx * dx) + delta) + m
    jstar = torch.where(eligible, hi, inf).argmin(-1, keepdim=True)
    prune = eligible.any(-1, keepdim=True)

    def at_j(v):
        return torch.gather(v.expand_as(hi), -1, jstar)

    j_y, j_x, j_2, j_m = at_j(cyd), at_j(cxd), at_j(c2d), at_j(m)
    dcy = cyd - j_y
    dcx = cxd - j_x
    gy = torch.maximum(y0 * dcy, y1 * dcy)
    gx = torch.maximum(x0 * dcx, x1 * dcx)
    g = (c2d - j_2) - 2.0 * (gy + gx)
    k_idx = torch.arange(cy.shape[1], device=py.device)
    drop = prune & eligible & (k_idx != jstar) & (g > m + j_m)
    return ~drop


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


def _launch(py, px, cy, cx, c2, kept_pairs) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (one count in
    ``center_argmin.launches``); anything it does not take raises."""
    if py.device.type != "cuda":
        raise ValueError(f"center_argmin: unsupported device {py.device}")
    b, h, w = py.shape
    k = cy.shape[1]
    if not 1 <= k <= MAX_CENTERS:
        raise ValueError(f"center_argmin: K={k} outside [1, {MAX_CENTERS}]")
    if b > _MAX_BATCH:
        raise ValueError(f"center_argmin: batch {b} > {_MAX_BATCH}")
    if -(-h // TILE_H) > _MAX_TILE_ROWS or w >= 2**31:
        raise ValueError(f"center_argmin: plane {h}x{w} too large")
    for name, t in dict(py=py, px=px, cy=cy, cx=cx, c2=c2).items():
        if not t.is_contiguous():
            raise ValueError(f"center_argmin: {name} must be contiguous")
    lib = load_library()
    out = torch.empty((b, h, w), dtype=torch.int32, device=py.device)
    with torch.cuda.device(py.device):
        stream = torch.cuda.current_stream(py.device).cuda_stream
        rc = lib.mgnet_center_argmin(
            py.data_ptr(), px.data_ptr(), cy.data_ptr(), cx.data_ptr(),
            c2.data_ptr(), out.data_ptr(), b, h, w, k,
            None if kept_pairs is None else kept_pairs.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"center_argmin: kernel launch failed "
                           f"(cudaError {rc})")
    center_argmin.launches += 1
    return out


# The op ``mgnet::center_argmin``: its CPU kernel is the plain version, its
# CUDA kernel the hand-written one; torch.export and AOTInductor see it
# through its fake (shape and dtype only) and keep it opaque. The C++
# runner registers the same schema (export/csrc/mgnet_ops.cpp).
@torch.library.custom_op("mgnet::center_argmin", mutates_args=(),
                         device_types="cpu")
def center_argmin_op(py: torch.Tensor, px: torch.Tensor, cy: torch.Tensor,
                     cx: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    return center_argmin_reference(py, px, cy, cx, c2)


@center_argmin_op.register_kernel("cuda")
def _center_argmin_cuda(py, px, cy, cx, c2):
    return _launch(py, px, cy, cx, c2, None)


@center_argmin_op.register_fake
def _center_argmin_fake(py, px, cy, cx, c2):
    return py.new_empty(py.shape, dtype=torch.int32)


def center_argmin(py, px, cy, cx, c2, *,
                  kept_pairs: torch.Tensor | None = None) -> torch.Tensor:
    """Nearest center index per pixel.

    Args:
        py, px: [B, H, W] f32 target coordinates (pixel + offset).
        cy, cx, c2: [B, K] f32 from ``center_inputs``.
        kept_pairs: None, or a one-element int64 tensor on py's device, to
            which the call adds the number of (tile, center) pairs the
            kernel scans (for CPU tensors: the count that
            ``center_candidates_reference`` keeps at the kernel's tile).
            Such a call launches the kernel directly, not through the op.

    Returns:
        [B, H, W] int32 indices in [0, K).

    Calls ``mgnet::center_argmin``: CUDA tensors launch the kernel (and
    count one launch in ``center_argmin.launches``); CPU tensors take
    ``center_argmin_reference``.
    """
    _check(py, px, cy, cx, c2)
    if kept_pairs is None:
        return center_argmin_op(py, px, cy, cx, c2)
    if (kept_pairs.dtype != torch.int64 or kept_pairs.numel() != 1
            or kept_pairs.device != py.device
            or not kept_pairs.is_contiguous()):
        raise ValueError("center_argmin: kept_pairs must be one contiguous "
                         "int64 element on py's device")
    if py.device.type == "cpu":
        kept_pairs += center_candidates_reference(py, px, cy, cx, c2).sum()
        return center_argmin_reference(py, px, cy, cx, c2)
    return _launch(py, px, cy, cx, c2, kept_pairs)


center_argmin.launches = 0
