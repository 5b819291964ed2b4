"""Seeded inputs of ``center_argmin``, made with numpy, as CPU tensors.

Shared by tests/test_torch_center_argmin.py (CPU) and
tests/test_torch_gpu.py (card; it imports no JAX, nor does this module).
Each case returns [py, px, cy, cx, c2]: py, px [B, H, W] f32 contiguous and
cy, cx, c2 [B, K] f32 from ``center_inputs``.
"""

from __future__ import annotations

import numpy as np
import torch

from mgnet_tpu_torch.ops.center_argmin import (
    center_argmin_reference,
    center_inputs,
)

CASES = ("grid", "scattered", "instance", "lattice", "bisector",
         "sentinels", "clamped", "huge", "nonfinite")


def _centers(rng, b, h, w, k, invalid=0.2):
    """Centers over the image with duplicates (exact ties), two outside it
    and invalid slots; slot 0 valid."""
    c = (rng.rand(b, k, 2) * [h, w]).astype(np.float32)
    if k >= 8:
        c[:, k // 2: k // 2 + 3] = c[:, 0:3]
        c[:, -2] = (-60.0, w + 90.0)
        c[:, -1] = (h + 30.0, -45.0)
    valid = rng.rand(b, k) > invalid
    valid[:, 0] = True
    return c, valid


def _grid(b, h, w):
    ys = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (b, h, w))
    xs = np.broadcast_to(np.arange(w, dtype=np.float32)[None], (b, h, w))
    return ys, xs


def _pack(py, px, c, valid):
    planes = [torch.from_numpy(np.ascontiguousarray(t, dtype=np.float32))
              for t in (py, px)]
    return planes + list(center_inputs(torch.from_numpy(c),
                                       torch.from_numpy(valid)))


def center_case(name: str, b: int, h: int, w: int, k: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    ys, xs = _grid(b, h, w)
    if name in ("grid", "sentinels", "clamped", "huge", "nonfinite"):
        # chip_smoke.py's case A: the pixel grid plus N(0, 20^2) offsets
        c, valid = _centers(rng, b, h, w, k)
        py = ys + 20 * rng.randn(b, h, w).astype(np.float32)
        px = xs + 20 * rng.randn(b, h, w).astype(np.float32)
        if name == "sentinels":
            valid[:] = False
        elif name == "clamped":
            # |c| ~ 1e16: |c|^2 ~ 1e32 is clamped to c2 = 1e30
            c[:, 1::5] = rng.choice([-1, 1], (b, len(range(1, k, 5)), 2)) \
                * rng.uniform(5e15, 2e16, (b, len(range(1, k, 5)), 2))
            valid[:, 1::5] = True
        elif name == "huge":
            # coordinates of 1e20: a band of pixels and some centers
            py[:, : h // 2] = py[:, : h // 2] * 1e17 + 1e20
            px[:, : h // 2] = px[:, : h // 2] * -1e17 - 1e20
            c[:, 2::7] = c[:, 2::7] * 1e17 + 1e20
        elif name == "nonfinite":
            for bb in range(b):
                for v in (np.nan, np.inf, -np.inf):
                    i, j = rng.randint(h), rng.randint(w)
                    (py if rng.rand() < 0.5 else px)[bb, i, j] = v
        return _pack(py, px, c, valid)
    if name == "scattered":
        # the worst case: targets uniform over the image
        c, valid = _centers(rng, b, h, w, k)
        py = rng.uniform(0, h, (b, h, w))
        px = rng.uniform(0, w, (b, h, w))
        return _pack(py, px, c, valid)
    if name == "instance":
        # what a trained offset head gives on thing pixels: each target
        # within N(0, 2^2) of the valid center nearest to its pixel
        c, valid = _centers(rng, b, h, w, k)
        args = _pack(ys, xs, c, valid)
        near = center_argmin_reference(*args).numpy()
        cy, cx = args[2].numpy(), args[3].numpy()
        rows = np.arange(b)[:, None, None]
        py = cy[rows, near] + 2 * rng.randn(b, h, w)
        px = cx[rows, near] + 2 * rng.randn(b, h, w)
        return _pack(py, px, c, valid)
    if name == "lattice":
        # near-ties at large coordinates: targets and centers on a
        # quarter-pixel lattice around (1000, 2000), where the f32 ulp of
        # c2 is 0.5; duplicates give exact ties
        base = np.array([1000.0, 2000.0])
        c = (base + 0.25 * rng.randint(-24, 24, (b, k, 2))).astype(
            np.float32)
        if k >= 4:
            c[:, k // 2] = c[:, 0]
        valid = rng.rand(b, k) > 0.1
        valid[:, 0] = True
        py = base[0] + 0.25 * rng.randint(-40, 40, (b, h, w))
        px = base[1] + 0.25 * rng.randint(-40, 40, (b, h, w))
        return _pack(py, px, c, valid)
    if name == "bisector":
        # targets on the bisector of (1000, 2000) and (1001, 2001), py + px
        # = 3001, or a quarter pixel off it; a duplicate of the first
        # center and further centers around
        c, valid = _centers(rng, b, 64, 64, k)
        c = (c + [980.0, 1980.0]).astype(np.float32)
        c[:, 0] = (1000.0, 2000.0)
        c[:, 1 % k] = (1001.0, 2001.0)
        c[:, 2 % k] = (1000.0, 2000.0)
        valid[:, :3] = True
        t = 0.25 * rng.randint(-60, 60, (b, h, w))
        e = 0.25 * rng.randint(-1, 2, (b, h, w))
        return _pack(1000.5 + t + e, 2000.5 - t + e, c, valid)
    raise ValueError(name)


def misaligned(args):
    """py, px as views one f32 element off 16-byte alignment (the
    kernel's scalar path); cy, cx, c2 as they are."""
    out = []
    for t in args[:2]:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t.flatten()
        out.append(buf[1:].view(t.shape))
    return out + list(args[2:])
