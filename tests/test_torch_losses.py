"""The training losses against the JAX package, on the CPU, in float32:
values and gradients.

Segmentation: cross entropy, the top-k% DeepLab CE, OHEM on both of its
branches, top-k sums, and the center / offset losses. Photometric:
``multi_view_photometric_loss`` over three scales and two context frames,
with automasking and a partial reprojection mask, with respect to the
inverse depths and the poses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgnet_tpu.losses import photometric as jp
from mgnet_tpu.losses import segmentation as js
from mgnet_tpu_torch.losses import photometric as tp
from mgnet_tpu_torch.losses import segmentation as ts

# f32 reductions over ~10^4 pixels in other orders
RTOL = 1e-5
GRAD_ATOL = 1e-6


def _seg_inputs(seed, b=2, h=24, w=32, c=20, scale=3.0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, h, w, c) * scale).astype(np.float32)
    labels = rng.randint(0, c, (b, h, w)).astype(np.int32)
    labels[rng.rand(b, h, w) < 0.1] = 255
    weights = np.where(rng.rand(b, h, w) < 0.2, 3.0, 1.0).astype(np.float32)
    return logits, labels, weights


def _dense_inputs(channels, zero_weights=False):
    rng = np.random.RandomState(4)
    pred = rng.randn(2, 16, 20, channels).astype(np.float32)
    target = rng.randn(2, 16, 20, channels).astype(np.float32)
    weights = (rng.rand(2, 16, 20) > 0.4).astype(np.float32)
    return pred, target, weights * (0.0 if zero_weights else 1.0)


def _ohem(n_min):
    return (lambda x, l, w: js.ohem_ce_loss(x, l, w, n_min=n_min),
            lambda x, l, w: ts.ohem_ce_loss(x, l, w, n_min=n_min))


def _deeplab(top_k):
    return (lambda x, l, w: js.deeplab_ce_loss(x, l, w, top_k_percent=top_k),
            lambda x, l, w: ts.deeplab_ce_loss(x, l, w, top_k_percent=top_k))


# case -> (JAX loss, port loss, numpy arguments); the first argument is
# the one differentiated
SEG_CASES = {
    "ce": (js.cross_entropy_loss, ts.cross_entropy_loss,
           _seg_inputs(0)[:2]),
    "ce_weighted": (js.cross_entropy_loss, ts.cross_entropy_loss,
                    _seg_inputs(0)),
    "deeplab_all": (*_deeplab(1.0), _seg_inputs(1)),
    "deeplab_top20": (*_deeplab(0.2), _seg_inputs(1)),
    # of the 1536 pixel losses about 1300 exceed -log(0.7): with n_min
    # 100 the mean of those is taken, with n_min 1500 the bisection's
    # top-n_min mean
    "ohem_above": (*_ohem(100), _seg_inputs(2)),
    "ohem_topk": (*_ohem(1500), _seg_inputs(2)),
    "center": (js.center_loss, ts.center_loss, _dense_inputs(1)),
    "offset": (js.offset_loss, ts.offset_loss, _dense_inputs(2)),
    "center_unweighted": (js.center_loss, ts.center_loss,
                          _dense_inputs(1, zero_weights=True)),
    "offset_unweighted": (js.offset_loss, ts.offset_loss,
                          _dense_inputs(2, zero_weights=True)),
}
TOPK_X = np.random.RandomState(3).exponential(size=5000).astype(np.float32)
TOPK_KS = (1, 17, 2500, 4999)


def _photo_inputs(seed, b=2, h=32, w=48):
    rng = np.random.RandomState(seed)
    image = rng.rand(b, h, w, 3).astype(np.float32)
    prev = np.clip(np.roll(image, 2, axis=2)
                   + 0.02 * rng.randn(b, h, w, 3), 0, 1).astype(np.float32)
    nxt = np.clip(np.roll(image, -2, axis=2)
                  + 0.02 * rng.randn(b, h, w, 3), 0, 1).astype(np.float32)
    inv = [rng.uniform(0.05, 1.5, (b, h, w, 1)).astype(np.float32)
           for _ in range(3)]
    poses = (rng.randn(b, 2, 6) * 0.02).astype(np.float32)
    K = np.array([[0.8 * w, 0, (w - 1) / 2], [0, 0.8 * w, (h - 1) / 2],
                  [0, 0, 1]], np.float32)
    K = np.broadcast_to(K, (b, 3, 3)).copy()
    mask = np.ones((b, h, w, 1), np.float32)
    mask[:, : h // 5] = 0.0
    return inv, poses, K, image, [prev, nxt], mask


PHOTO = _photo_inputs(5)


@pytest.fixture(scope="module")
def jax_losses():
    """Every JAX value and gradient the tests compare with, computed
    once."""
    seg = {}
    for name, (jfn, _, args) in SEG_CASES.items():
        val, grad = jax.jit(jax.value_and_grad(
            lambda x, *r, f=jfn: f(x, *r)))(*map(jnp.asarray, args))
        seg[name] = (float(val), np.asarray(grad))
    topk = {k: float(jax.jit(js.topk_sum, static_argnums=1)(
        jnp.asarray(TOPK_X), k)) for k in TOPK_KS}
    inv, poses, K, image, ctx, mask = PHOTO
    photo = {}
    for automask in (True, False):
        def loss(inv_list, p, automask=automask):
            out = jp.multi_view_photometric_loss(
                inv_list, p, jnp.asarray(K), jnp.asarray(image),
                [jnp.asarray(c) for c in ctx], jnp.asarray(mask),
                automask_loss=automask)
            return out["loss_photometric"] + out["loss_smoothness"], out

        (_, out), (dinv, dpose) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
            [jnp.asarray(d) for d in inv], jnp.asarray(poses))
        photo[automask] = ({k: float(v) for k, v in out.items()},
                           [np.asarray(d) for d in dinv], np.asarray(dpose))
    return seg, topk, photo


def _check_seg(jax_losses, name):
    jval, jgrad = jax_losses[0][name]
    _, tfn, args = SEG_CASES[name]
    t = torch.from_numpy(args[0]).requires_grad_()
    tval = tfn(t, *(torch.from_numpy(a) for a in args[1:]))
    tval.backward()
    assert float(tval.detach()) == pytest.approx(jval, rel=RTOL, abs=1e-7)
    np.testing.assert_allclose(t.grad.numpy(), jgrad, rtol=1e-4,
                               atol=GRAD_ATOL)
    return float(tval.detach()), t.grad.numpy()


@pytest.mark.parametrize("name", ["ce", "ce_weighted"])
def test_cross_entropy(jax_losses, name):
    _check_seg(jax_losses, name)


@pytest.mark.parametrize("name", ["deeplab_all", "deeplab_top20"])
def test_deeplab_ce(jax_losses, name):
    _check_seg(jax_losses, name)


@pytest.mark.parametrize("name,n_min", [("ohem_above", 100),
                                        ("ohem_topk", 1500)])
def test_ohem_both_branches(jax_losses, name, n_min):
    logits, labels, weights = SEG_CASES[name][2]
    ce, _ = ts._per_pixel_ce(torch.from_numpy(logits),
                             torch.from_numpy(labels), 255)
    count = int(((ce * torch.from_numpy(weights)) > -np.log(0.7)).sum())
    assert (count > n_min) == (name == "ohem_above")
    _check_seg(jax_losses, name)


def test_topk_sum_matches_the_jax_bisection(jax_losses):
    for k in TOPK_KS:
        got = float(ts.topk_sum(torch.from_numpy(TOPK_X), k))
        assert got == pytest.approx(jax_losses[1][k], rel=1e-6)
        assert got == pytest.approx(float(np.sort(TOPK_X)[::-1][:k].sum()),
                                    rel=1e-4)


@pytest.mark.parametrize("name", ["center", "offset"])
def test_center_and_offset(jax_losses, name):
    _check_seg(jax_losses, name)
    val, grad = _check_seg(jax_losses, name + "_unweighted")
    assert val == 0.0 and not grad.any()


@pytest.mark.parametrize("automask", [True, False])
def test_photometric_loss_values_and_gradients(jax_losses, automask):
    jout, jdinv, jdpose = jax_losses[2][automask]
    inv, poses, K, image, ctx, mask = PHOTO
    tinv = [torch.from_numpy(d).requires_grad_() for d in inv]
    tpose = torch.from_numpy(poses).requires_grad_()
    tout = tp.multi_view_photometric_loss(
        tinv, tpose, torch.from_numpy(K), torch.from_numpy(image),
        [torch.from_numpy(c) for c in ctx], torch.from_numpy(mask),
        automask_loss=automask)
    (tout["loss_photometric"] + tout["loss_smoothness"]).backward()
    for k in ("loss_photometric", "loss_smoothness"):
        assert float(tout[k].detach()) == pytest.approx(jout[k],
                                                        rel=RTOL), k
    # gradient magnitudes: d/dpose ~1e-1, d/dinv ~1e-5 per pixel
    np.testing.assert_allclose(tpose.grad.numpy(), jdpose, rtol=1e-3,
                               atol=1e-6)
    for i, (t, j) in enumerate(zip(tinv, jdinv)):
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=1e-3,
                                   atol=1e-4 * np.abs(j).max(),
                                   err_msg=f"d/d inv_depths[{i}]")
