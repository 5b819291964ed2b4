"""The warp of the view synthesis against the JAX package, on the CPU.

The plain version of the warp kernel (``warp_bilinear_reference``, what a
CPU tensor runs) against JAX ``_grid_sample_core`` and against the TPU
kernel ``warp_bilinear_banded`` in interpret mode, for the value and the
gx, gy fields; and the port's ``grid_sample`` autograd against
``jax.grad`` of JAX ``grid_sample`` for the coordinates and the image.
Every JAX evaluation happens once, in a module-scoped fixture.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgnet_tpu.geometry.image import _grid_sample_core
from mgnet_tpu.geometry.image import grid_sample as j_grid_sample
from mgnet_tpu.ops.pallas.warp import warp_bilinear_banded
from mgnet_tpu_torch.geometry.image import grid_sample, grid_sample_planar
from mgnet_tpu_torch.ops.warp import warp_bilinear, warp_bilinear_reference

# [1, 24, 384, 3]: the smallest shape the TPU kernel takes
# (pallas_warp_supported: H % 8 == 0, W % 128 == 0, W >= 384, H >= 24)
B, H, W, C = 1, 24, 384, 3
CASES = {
    "sfm": dict(scale=1.05, jitter=0.5),
    "integer": dict(scale=1.0, jitter=0.0, shift=(3.0, 2.0)),
    "violators": dict(scale=1.0, jitter=6.0),
    "off_image": dict(scale=1.0, jitter=0.3, shift=(300.0, 10.0)),
}
# value: image in [0, 1], f32 elementwise in both; gx, gy carry the
# (W-1)/2 = 191.5 and (H-1)/2 factors, so their bar scales with them
VALUE_ATOL = 1e-6
FIELD_ATOL = 1e-6 * (W - 1) / 2
# the TPU kernel rebuilds f32 corner values from three bf16 terms (~1 ulp)
# and takes its y-interpolation through a hat-weighted sum: the bars of
# tests/test_pallas_ops.py::test_banded_warp_matches_xla
BANDED_VALUE_ATOL = 2e-5
BANDED_FIELD_ATOL = 2e-4


def _coords(scale=1.0, jitter=0.5, shift=(0.0, 0.0), seed=0):
    """SfM-like normalized coords: radial scale + shift + jitter."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    cx, cy = (W - 1) / 2, (H - 1) / 2
    x = cx + (xx - cx) * scale + shift[0] + rng.randn(B, H, W) * jitter
    y = cy + (yy - cy) * scale + shift[1] + rng.randn(B, H, W) * jitter
    return np.stack([2 * x / (W - 1) - 1, 2 * y / (H - 1) - 1],
                    axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def jax_warps():
    image = np.random.RandomState(1).rand(B, H, W, C).astype(np.float32)
    core = jax.jit(lambda i, c: _grid_sample_core(i, c, "zeros", True))
    banded = jax.jit(lambda i, c: warp_bilinear_banded(
        i, c, "zeros", with_grads=True, band_terms=3, interpret=True))
    out = {}
    for name, kw in CASES.items():
        coords = _coords(**kw)
        out[name] = dict(
            coords=coords,
            core=[np.asarray(a) for a in core(image, coords)],
            banded=[np.asarray(a) for a in banded(image, coords)])
    return image, out


def _plain(image, coords):
    img = torch.from_numpy(image).permute(0, 3, 1, 2).contiguous()
    out = warp_bilinear(img, torch.from_numpy(coords))
    return [t.permute(0, 2, 3, 1).numpy() for t in out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_warp_matches_jax_core(jax_warps, case):
    image, runs = jax_warps
    got = _plain(image, runs[case]["coords"])
    for name, g, w, atol in zip(("out", "gx", "gy"), got,
                                runs[case]["core"],
                                (VALUE_ATOL, FIELD_ATOL, FIELD_ATOL)):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                   err_msg=f"{case}: {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_warp_matches_tpu_kernel_interpret(jax_warps, case):
    image, runs = jax_warps
    got = _plain(image, runs[case]["coords"])
    for name, g, w, atol in zip(
            ("out", "gx", "gy"), got, runs[case]["banded"],
            (BANDED_VALUE_ATOL, BANDED_FIELD_ATOL, BANDED_FIELD_ATOL)):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                   err_msg=f"{case}: {name}")


def test_cpu_tensors_take_the_plain_version_uncounted():
    rng = np.random.RandomState(2)
    img = torch.from_numpy(rng.rand(2, 3, 8, 12).astype(np.float32))
    coords = torch.from_numpy(
        rng.uniform(-1.2, 1.2, (2, 5, 7, 2)).astype(np.float32))
    before = warp_bilinear.launches
    got = warp_bilinear(img, coords)
    want = warp_bilinear_reference(img, coords)
    assert warp_bilinear.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    out, gx, gy = warp_bilinear(img, coords, with_grads=False)
    assert gx is None and gy is None and torch.equal(out, want[0])


def _grad_case():
    rng = np.random.RandomState(3)
    b, h, w, c = 2, 9, 13, 3
    image = rng.rand(b, h, w, c).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (b, 7, 11, 2)).astype(np.float32)
    weight = rng.randn(b, 7, 11, c).astype(np.float32)
    return image, coords, weight


@pytest.fixture(scope="module")
def jax_grid_sample_grads():
    """Value and (d/dimage, d/dcoords) of sum(G * grid_sample(image,
    coords)) through JAX grid_sample's custom VJP, per padding mode."""
    image, coords, weight = _grad_case()
    out = {}
    for mode in ("zeros", "border"):
        def loss(i, cc, mode=mode):
            return jnp.sum(jnp.asarray(weight) * j_grid_sample(i, cc, mode))

        val, (di, dc) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
            jnp.asarray(image), jnp.asarray(coords))
        out[mode] = float(val), np.asarray(di), np.asarray(dc)
    return out


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_gradients_match_jax(jax_grid_sample_grads,
                                         padding_mode):
    """Value, d/dcoords and d/dimage of sum(G * grid_sample(image, coords))
    against jax.grad of JAX grid_sample (its custom VJP)."""
    jval, jdi, jdc = jax_grid_sample_grads[padding_mode]
    image, coords, weight = _grad_case()
    ti = torch.from_numpy(image).requires_grad_()
    tc = torch.from_numpy(coords).requires_grad_()
    tval = (torch.from_numpy(weight)
            * grid_sample(ti, tc, padding_mode)).sum()
    tval.backward()
    assert float(tval.detach()) == pytest.approx(jval, rel=1e-6)
    np.testing.assert_allclose(tc.grad.numpy(), jdc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti.grad.numpy(), jdi, rtol=1e-5, atol=1e-6)


def test_planar_and_nhwc_grid_sample_agree():
    rng = np.random.RandomState(4)
    image = torch.from_numpy(rng.rand(1, 6, 10, 3).astype(np.float32))
    coords = torch.from_numpy(
        rng.uniform(-1, 1, (1, 4, 5, 2)).astype(np.float32))
    nhwc = grid_sample(image, coords)
    planar = grid_sample_planar(image.permute(0, 3, 1, 2), coords)
    assert torch.equal(nhwc, planar.permute(0, 2, 3, 1))


def test_unsupported_padding_raises():
    img = torch.zeros(1, 3, 4, 4)
    with pytest.raises(ValueError, match="padding_mode"):
        grid_sample_planar(img, torch.zeros(1, 2, 2, 2), "reflection")
