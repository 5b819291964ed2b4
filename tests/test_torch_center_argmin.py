"""The port's center_argmin against the JAX package's Pallas kernel.

On the CPU the wrapper runs its plain version; it is held EXACTLY (index
for index) against ``mgnet_tpu.ops.pallas.center_argmin`` in interpret
mode, variant "kloop" (the TPU default), batched, with invalid, duplicate
and out-of-image centers. The kernel itself is compared with the plain
version on the card in tests/test_torch_gpu.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgnet_tpu.ops.pallas.center_argmin import center_argmin as jax_argmin
from mgnet_tpu_torch.ops.center_argmin import (
    center_argmin,
    center_argmin_reference,
    center_inputs,
)


def _case(seed, b=3, h=40, w=72, k=16):
    """Pixel targets near the grid, centers with duplicates (exact ties),
    out-of-image centers and invalid slots."""
    rng = np.random.RandomState(seed)
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None]
    py = ys + rng.randn(b, h, w).astype(np.float32) * 6
    px = xs + rng.randn(b, h, w).astype(np.float32) * 6
    centers = rng.uniform(0, [h, w], (b, k, 2)).astype(np.float32)
    if k >= 8:
        centers[:, k // 2: k // 2 + 3] = centers[:, 0:3]    # duplicates
        centers[:, -2] = (-30.0, w + 40.0)                  # outside
    valid = rng.rand(b, k) > 0.25
    valid[:, 0] = True
    return py, px, centers, valid


def _jax(py, px, centers, valid):
    pts = jnp.stack([jnp.asarray(py), jnp.asarray(px)], axis=-1)
    fn = lambda p, c, v: jax_argmin(p, c, v, interpret=True,
                                    variant="kloop")
    return np.asarray(jax.vmap(fn)(pts, jnp.asarray(centers),
                                   jnp.asarray(valid)))


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_jax_kernel_exactly(seed):
    py, px, centers, valid = _case(seed)
    want = _jax(py, px, centers, valid)
    args = (torch.from_numpy(py), torch.from_numpy(px),
            *center_inputs(torch.from_numpy(centers),
                           torch.from_numpy(valid)))
    got = center_argmin_reference(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = center_argmin.launches
    np.testing.assert_array_equal(center_argmin(*args).numpy(), want)
    assert center_argmin.launches == before


def test_ties_go_to_the_lowest_index():
    py = torch.full((1, 2, 3), 5.0)
    px = torch.full((1, 2, 3), 5.0)
    centers = torch.tensor([[[0.0, 0.0], [5.0, 5.0], [5.0, 5.0], [5.0, 5.0]]])
    valid = torch.tensor([[True, False, True, True]])
    out = center_argmin(py, px, *center_inputs(centers, valid))
    assert (out == 2).all()


def test_center_inputs_sentinel_and_clamp():
    centers = torch.tensor([[[1.0, 2.0], [3.0, 4.0]]])
    valid = torch.tensor([[True, False]])
    cy, cx, c2 = center_inputs(centers, valid)
    big = float(np.float32(1e12))
    assert cy.tolist() == [[1.0, big]] and cx.tolist() == [[2.0, big]]
    assert c2[0, 0].item() == 5.0
    assert c2[0, 1].item() == pytest.approx(2e24, rel=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "rank", "centers", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    py, px, centers, valid = _case(0, b=1, h=4, w=5, k=3)
    args = [torch.from_numpy(py), torch.from_numpy(px),
            *center_inputs(torch.from_numpy(centers),
                           torch.from_numpy(valid))]
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "rank":
        args[0] = args[0][0]
    elif bad == "centers":
        args[4] = args[4][:, :2]
    else:
        args[0] = args[0].to("meta")
    with pytest.raises((TypeError, ValueError)):
        center_argmin(*args)
