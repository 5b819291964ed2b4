"""The fused SSIM + L1 residual against the JAX package, on the CPU.

The plain versions of the two SSIM kernels (what a CPU tensor runs):
the forward against the TPU kernel ``_residual_batched`` in interpret
mode, the backward against the TPU backward kernel ``_bwd_batched`` in
interpret mode and against ``torch.autograd`` through the plain forward
in float64. Every JAX evaluation happens once, in a module-scoped
fixture.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from mgnet_tpu.ops.pallas.ssim import _bwd_batched, _residual_batched
from mgnet_tpu_torch.ops.ssim import (
    fused_photometric_residual,
    ssim_residual_bwd,
    ssim_residual_bwd_reference,
    ssim_residual_fwd,
    ssim_residual_reference,
)

# the last two take the forward kernel's channel count other than 3 (C =
# 1 and C = 2), at the same tolerances
SHAPES = [(2, 3, 40, 56), (1, 3, 130, 200), (1, 3, 3, 5), (1, 1, 17, 18),
          (1, 2, 33, 61)]
# f32 elementwise on values in [0, 1]: the two sides sum the pool windows
# and the channel mean in other orders and divide by 9 and 3 where the
# port multiplies by the f32 reciprocal. The backward's cotangents cancel
# (gA - gB, gC - gD), which magnifies those ulps: measured 2.2e-6 at
# [1, 3, 130, 200], where |dx| reaches 0.5
FWD_ATOL = 2e-6
BWD_ATOL = 5e-6
# f32 closed form against float64 autograd of the plain forward
AUTOGRAD_ATOL = 1e-5


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    b, _, h, w = shape
    x = rng.rand(*shape).astype(np.float32)
    y = np.clip(x + 0.2 * rng.randn(*shape), 0, 1).astype(np.float32)
    g = rng.rand(b, h, w).astype(np.float32)
    return x, y, g


@pytest.fixture(scope="module")
def jax_ssim():
    fwd = jax.jit(lambda x, y: _residual_batched(
        x, y, 0.85, 1e-4, 9e-4, interpret=True, planar=True))
    bwd = jax.jit(lambda x, y, g: _bwd_batched(
        x, y, g[..., None], 0.85, 1e-4, 9e-4, interpret=True, planar=True))
    out = {}
    for i, shape in enumerate(SHAPES):
        x, y, g = _inputs(shape, i)
        out[shape] = dict(x=x, y=y, g=g, fwd=np.asarray(fwd(x, y)),
                          bwd=[np.asarray(a) for a in bwd(x, y, g)])
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_tpu_kernel_interpret(jax_ssim, shape):
    r = jax_ssim[shape]
    got = ssim_residual_fwd(torch.from_numpy(r["x"]),
                            torch.from_numpy(r["y"]), 0.85)
    assert got.shape == (shape[0],) + shape[2:]
    np.testing.assert_allclose(got.numpy(), r["fwd"], rtol=0,
                               atol=FWD_ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_tpu_kernel_interpret(jax_ssim, shape):
    r = jax_ssim[shape]
    dx, dy = ssim_residual_bwd(torch.from_numpy(r["x"]),
                               torch.from_numpy(r["y"]),
                               torch.from_numpy(r["g"]), 0.85)
    np.testing.assert_allclose(dx.numpy(), r["bwd"][0], rtol=0,
                               atol=BWD_ATOL)
    np.testing.assert_allclose(dy.numpy(), r["bwd"][1], rtol=0,
                               atol=BWD_ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_autograd_float64(shape):
    """The closed form in f64 equals autograd of the plain forward to
    rounding, and the f32 closed form is within AUTOGRAD_ATOL of it."""
    x, y, g = (torch.from_numpy(a).double() for a in _inputs(shape, 7))
    xr, yr = x.clone().requires_grad_(), y.clone().requires_grad_()
    (ssim_residual_reference(xr, yr, 0.85) * g).sum().backward()
    dx64, dy64 = ssim_residual_bwd_reference(x, y, g, 0.85)
    np.testing.assert_allclose(dx64.numpy(), xr.grad.numpy(), atol=1e-12)
    np.testing.assert_allclose(dy64.numpy(), yr.grad.numpy(), atol=1e-12)
    dx, dy = ssim_residual_bwd_reference(x.float(), y.float(), g.float(),
                                         0.85)
    np.testing.assert_allclose(dx.numpy(), xr.grad.numpy(),
                               atol=AUTOGRAD_ATOL)
    np.testing.assert_allclose(dy.numpy(), yr.grad.numpy(),
                               atol=AUTOGRAD_ATOL)


def test_fused_residual_autograd_uses_the_closed_form():
    x, y, g = (torch.from_numpy(a) for a in _inputs((2, 3, 9, 11), 8))
    xr = x.clone().requires_grad_()
    before = (ssim_residual_fwd.launches, ssim_residual_bwd.launches)
    out = fused_photometric_residual(xr, y, 0.85)
    assert torch.equal(out.detach(), ssim_residual_reference(x, y, 0.85))
    (out * g).sum().backward()
    dx, _ = ssim_residual_bwd_reference(x, y, g, 0.85)
    assert torch.equal(xr.grad, dx)
    # CPU tensors run the plain versions, which count no launch
    assert (ssim_residual_fwd.launches, ssim_residual_bwd.launches) == before
    # no input needs a gradient: no backward graph
    assert not fused_photometric_residual(x, y, 0.85).requires_grad


def test_rejects_what_the_kernels_do_not_take():
    x = torch.zeros(1, 3, 1, 8)
    with pytest.raises(ValueError, match="H, W >= 2"):
        ssim_residual_fwd(x, x)
    with pytest.raises(TypeError, match="float32"):
        ssim_residual_fwd(x.double(), x.double())
    z = torch.zeros(1, 3, 4, 4)
    with pytest.raises(ValueError, match="g must be"):
        ssim_residual_bwd(z, z, torch.zeros(1, 4, 5))
