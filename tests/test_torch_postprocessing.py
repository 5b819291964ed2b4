"""Post-processing and geometry of the port against the JAX package.

Inputs are made with numpy from a seed and handed to both sides. Stated
bars:
* find_instance_centers (tied scores) and panoptic_fusion: exact;
* _masked_median: exact, including the empty mask (+inf);
* dgc_scale_factor: rel 1e-5;
* surface_normals, interpolation, camera, normalization: 1e-5 to 1e-4
  (float32, differently ordered arithmetic).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgnet_tpu.geometry import Camera as JCamera
from mgnet_tpu.geometry.depth import inv2depth as j_inv2depth
from mgnet_tpu.geometry.image import (
    interpolate_bilinear as j_bilinear,
    interpolate_bilinear_cf as j_bilinear_cf,
    interpolate_nearest as j_nearest,
)
from mgnet_tpu.postprocessing import depth as jdepth
from mgnet_tpu.postprocessing.panoptic import (
    find_instance_centers as j_centers,
    panoptic_fusion as j_fusion,
)
from mgnet_tpu.train.step import normalize_images as j_normalize
from mgnet_tpu_torch.geometry import (
    Camera,
    inv2depth,
    interpolate_bilinear,
    interpolate_bilinear_cf,
    interpolate_nearest,
)
from mgnet_tpu_torch.ops.center_argmin import center_argmin_reference
from mgnet_tpu_torch.postprocessing import depth as tdepth
from mgnet_tpu_torch.postprocessing.panoptic import (
    find_instance_centers,
    panoptic_fusion,
)
from mgnet_tpu_torch.train.step import normalize_images

def T(a) -> torch.Tensor:
    """numpy (or JAX) array -> a CPU tensor that owns a copy."""
    return torch.from_numpy(np.array(a))


def _heatmap_with_ties(seed, h=48, w=80):
    """A heatmap whose NMS peaks include exactly tied scores."""
    rng = np.random.RandomState(seed)
    hm = rng.uniform(0, 0.35, (h, w)).astype(np.float32)
    peaks = [(5, 5), (5, 40), (30, 12), (30, 60), (40, 30), (20, 70)]
    for i, (y, x) in enumerate(peaks):
        hm[y, x] = 0.9 if i % 2 == 0 else 0.8   # three-way ties
    return hm


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 8), (2, 3)])
def test_find_instance_centers_exact_with_ties(seed, k):
    hm = _heatmap_with_ties(seed)
    jc, jv, js = map(np.asarray, j_centers(jnp.asarray(hm), 0.3, 7, k))
    tc, tv, ts = find_instance_centers(T(hm)[None], 0.3, 7, k)
    np.testing.assert_array_equal(tv[0].numpy(), jv)
    np.testing.assert_array_equal(ts[0].numpy(), js)
    # only valid slots carry a defined center (panoptic.py:66-71)
    np.testing.assert_array_equal(tc[0].numpy()[jv], jc[jv])


def _fusion_inputs(seed, h=64, w=96, n_cls=14):
    """sem / heatmap / offsets on a quarter-pixel lattice, so that both the
    JAX CPU path (|p - c|^2) and the port's expanded form are exact in f32
    and agree even on exact distance ties."""
    rng = np.random.RandomState(seed)
    sem = rng.randint(0, n_cls, (h, w)).astype(np.int32)
    sem[: h // 2, : w // 2] = 12          # a large thing region
    sem[h // 2:, w // 2:] = 3             # a large stuff region
    hm = _heatmap_with_ties(seed, h, w)
    off = (np.round(rng.randn(h, w, 2) * 12 * 4) / 4).astype(np.float32)
    return sem, hm, off


@pytest.mark.parametrize("stuff_area", [0, 200])
@pytest.mark.parametrize("seed", [0, 1])
def test_panoptic_fusion_exact(seed, stuff_area):
    kw = dict(num_classes=14, last_stuff_id=10, label_divisor=1000,
              stuff_area=stuff_area, void_label=-1, threshold=0.3,
              nms_kernel=7, max_instances=8)
    sems, hms, offs = zip(*[_fusion_inputs(seed + 10 * i) for i in range(2)])
    want = np.stack([np.asarray(j_fusion(jnp.asarray(s), jnp.asarray(c),
                                         jnp.asarray(o), **kw))
                     for s, c, o in zip(sems, hms, offs)])
    got = panoptic_fusion(T(np.stack(sems)), T(np.stack(hms)),
                          T(np.stack(offs)), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want % 1000 > 0).any()        # instances were formed
    # the plain clustering function slots in for the kernel
    np.testing.assert_array_equal(
        panoptic_fusion(T(np.stack(sems)), T(np.stack(hms)),
                        T(np.stack(offs)), argmin=center_argmin_reference,
                        **kw).numpy(), want)


@pytest.mark.parametrize("case", ["random", "ties", "empty", "one", "even"])
def test_masked_median_exact(case):
    rng = np.random.RandomState(3)
    v = rng.randn(2, 17, 23).astype(np.float32)
    m = rng.rand(2, 17, 23) > 0.6
    if case == "ties":
        v = np.round(v * 2) / 2
    elif case == "empty":
        m[1] = False
    elif case == "one":
        m[:] = False
        m[0, 3, 4] = m[1, 0, 0] = True
    elif case == "even":
        m[:] = False
        m[:, :2, :2] = True
    want = np.asarray(jax.vmap(jdepth._masked_median)(jnp.asarray(v),
                                                      jnp.asarray(m)))
    got = tdepth._masked_median(T(v), T(m)).numpy()
    np.testing.assert_array_equal(got, want)


def _points(seed, b=2, h=24, w=40):
    """Depth of a flat ground 1.5 below the camera in the lower half of
    the image, random depth above it."""
    rng = np.random.RandomState(seed)
    cy = h / 2 - 0.5
    K = np.array([[60.0, 0, w / 2 - 0.5], [0, 60.0, cy], [0, 0, 1]],
                 np.float32)
    depth = (4.0 + rng.rand(b, h, w, 1) * 2).astype(np.float32)
    rows = np.arange(h // 2, h, dtype=np.float32)
    depth[:, h // 2:] = (60.0 * 1.5 / (rows - cy))[None, :, None, None]
    return np.stack([K] * b), depth


def test_surface_normals_and_camera():
    K, depth = _points(0)
    jp = np.asarray(JCamera(K=jnp.asarray(K)).reconstruct(
        jnp.asarray(depth), frame="c"))
    tp = Camera(T(K)).reconstruct(T(depth), frame="c").numpy()
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(Camera(T(K)).Kinv.numpy(),
                               np.asarray(JCamera(K=jnp.asarray(K)).Kinv),
                               rtol=1e-7)
    jn = np.asarray(jdepth.surface_normals(jnp.asarray(jp)))
    tn = tdepth.surface_normals(T(jp)).numpy()
    np.testing.assert_allclose(tn, jn, atol=1e-5)


@pytest.mark.parametrize("ground", ["mask", "geometric"])
def test_dgc_scale_factor(ground):
    K, depth = _points(1)
    jp = JCamera(K=jnp.asarray(K)).reconstruct(jnp.asarray(depth), frame="c")
    pts = np.asarray(jp)
    height = np.array([1.2, 1.7], np.float32)
    mask = None
    if ground == "mask":
        mask = np.zeros(depth.shape[:3], bool)
        mask[:, -8:] = True
    want = np.asarray(jdepth.dgc_scale_factor(
        jp, jnp.asarray(height), None if mask is None else jnp.asarray(mask)))
    got = tdepth.dgc_scale_factor(
        T(pts), T(height), None if mask is None else T(mask)).numpy()
    assert np.isfinite(want).all() and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("size", [(16, 24), (13, 29), (8, 12)])
def test_interpolation(size):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 12, 3).astype(np.float32)
    np.testing.assert_allclose(
        interpolate_bilinear(T(x), size).numpy(),
        np.asarray(j_bilinear(jnp.asarray(x), size)), atol=1e-5)
    xc = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    np.testing.assert_allclose(
        interpolate_bilinear_cf(T(xc), size).numpy(),
        np.asarray(j_bilinear_cf(jnp.asarray(xc), size)), atol=1e-5)
    # nearest: exact; the port's takes NCHW
    np.testing.assert_array_equal(
        interpolate_nearest(T(xc), size).numpy().transpose(0, 2, 3, 1),
        np.asarray(j_nearest(jnp.asarray(x), size)))


def test_normalize_and_inv2depth():
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    np.testing.assert_allclose(
        normalize_images(T(img), mean, std).numpy(),
        np.asarray(j_normalize(jnp.asarray(img), mean, std)), rtol=1e-6,
        atol=1e-6)
    inv = rng.rand(2, 5, 7, 1).astype(np.float32) * 2
    inv[0, 0, 0, 0] = 0.0
    np.testing.assert_allclose(inv2depth(T(inv)).numpy(),
                               np.asarray(j_inv2depth(jnp.asarray(inv))),
                               rtol=1e-6)
