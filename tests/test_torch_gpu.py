"""Hand-written kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips without a CUDA card (the kernels have no
CPU mode). This file imports no JAX, so that it also runs on a machine
without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

from __future__ import annotations

import pytest
import torch

from mgnet_tpu_torch.ops.center_argmin import (
    center_argmin,
    center_argmin_reference,
    center_inputs,
)


def _center_case(b, h, w, k, seed=0):
    """Coordinates near the grid; centers with duplicates (exact ties),
    out-of-image ones and invalid slots."""
    g = torch.Generator().manual_seed(seed)
    ys = torch.arange(h, dtype=torch.float32)[:, None]
    xs = torch.arange(w, dtype=torch.float32)[None]
    py = ys + 20 * torch.randn(b, h, w, generator=g)
    px = xs + 20 * torch.randn(b, h, w, generator=g)
    centers = torch.rand(b, k, 2, generator=g) * torch.tensor([h, w])
    if k >= 8:
        centers[:, k // 2: k // 2 + 3] = centers[:, 0:3]
        centers[:, -2] = torch.tensor([-30.0, w + 40.0])
    valid = torch.rand(b, k, generator=g) > 0.25
    valid[:, 0] = True
    return [t.cuda() for t in (py, px, *center_inputs(centers, valid))]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,k", [(1, 1024, 2048, 128), (3, 37, 53, 5),
                                     (2, 8, 12, 1)])
def test_center_argmin_kernel_matches_plain_version(b, h, w, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = _center_case(b, h, w, k)
    before = center_argmin.launches
    got = center_argmin(*args)
    torch.cuda.synchronize()
    assert center_argmin.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (b, h, w)
    assert torch.equal(got, center_argmin_reference(*args))
