"""The port's fused frame against ``mgnet_tpu.inference.fused``.

Both sides run the same flax-initialised weights (BN redrawn with numpy,
carried across by ``load_jax_params``), in float32
(``COMPUTE_DTYPE="float32"``), on the same seeded images and cameras.
Stated bars:
* continuous outputs (center, offset, depth, points): 1e-4 abs and rel;
* sem_seg and panoptic: equal on >= 99.9% of pixels (an argmax near-tie
  may flip one pixel's class; everything downstream of it follows).
Depth and points are compared where the panoptic maps agree, since the
depth filters read them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgnet_tpu.config import get_default_config as jax_config
from mgnet_tpu.data.catalog import Metadata as JMetadata
from mgnet_tpu.data.categories import (
    CITYSCAPES_SCENE_SEG_CATEGORIES as JCATS,
    build_meta as j_build_meta,
)
from mgnet_tpu.inference.fused import (
    build_fused_inference as j_build_fused,
    statics_from_meta as j_statics,
)
from mgnet_tpu.models.mgnet import build_model as j_build_model
from mgnet_tpu.utils.weights import flatten_params
from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.data import (
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    Metadata,
    build_meta,
)
from mgnet_tpu_torch.inference import build_fused_inference, statics_from_meta
from mgnet_tpu_torch.models import build_model
from mgnet_tpu_torch.utils import load_jax_params
from test_torch_models import randomized  # tests/ is on sys.path

B, H, W = 2, 64, 128
ATOL = RTOL = 1e-4
AGREE = 0.999


def _configure(cfg):
    cfg.MODEL.COMPUTE_DTYPE = "float32"
    cfg.MODEL.GCM.GCM_CHANNELS = 32
    h = cfg.MODEL.SEM_SEG_HEAD
    h.ARM_CHANNELS, h.REFINE_CHANNELS = [32, 32], [32, 32]
    h.FFM_CHANNELS, h.HEAD_CHANNELS = 48, 32
    cfg.INPUT.IGNORED_CATEGORIES_IN_DEPTH = ["ego vehicle", "sky"]
    return cfg


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(21)
    image = rng.randint(0, 256, (B, H, W, 3)).astype(np.float32)
    K = np.stack([
        np.array([[70.0, 0, 63.5], [0, 71.0, 31.5], [0, 0, 1]], np.float32),
        np.array([[90.0, 0, 60.0], [0, 88.0, 30.0], [0, 0, 1]], np.float32),
    ])
    height = np.array([1.22, 1.6], np.float32)

    jcfg = _configure(jax_config())
    jmodel = j_build_model(jcfg)
    init = jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(0), x,
                                         train=False))
    variables = randomized(init(jnp.asarray(image)), 0)
    params, stats = variables["params"], variables["batch_stats"]
    flat = {**flatten_params(params), **flatten_params(stats)}

    cfg = _configure(get_default_config())
    model = build_model(cfg, device="cpu")
    model.load_state_dict(load_jax_params(flat, model))
    statics = statics_from_meta(
        cfg, Metadata(name="t").set(**build_meta(
            CITYSCAPES_SCENE_SEG_CATEGORIES)))
    jstatics = j_statics(jcfg, JMetadata(name="t").set(**j_build_meta(JCATS)))
    assert tuple(statics) == tuple(jstatics)[: len(statics)]

    def port(st):
        fn = build_fused_inference(model, st, cfg.MODEL.PIXEL_MEAN,
                                   cfg.MODEL.PIXEL_STD, device="cpu")
        return {k: v.numpy() for k, v in fn(image, K, height).items()}

    # random heads rarely predict road: let the most common stuff class
    # stand in as the ground, so that the DGC median sees pixels
    pan = port(statics)["panoptic"]
    stuff = pan[(pan >= 0) & (pan % 1000 == 0)]
    road = int(np.bincount(stuff // 1000).argmax()) * 1000
    statics = statics._replace(road_class_id=road)
    jstatics = jstatics._replace(road_class_id=road)

    jfn = jax.jit(j_build_fused(jmodel, jstatics, jcfg.MODEL.PIXEL_MEAN,
                                jcfg.MODEL.PIXEL_STD))
    want = {k: np.asarray(v) for k, v in jfn(
        {"model": params}, stats, jnp.asarray(image), jnp.asarray(K),
        jnp.asarray(height)).items()}
    return port(statics), want


def test_same_outputs(frames):
    got, want = frames
    assert set(got) == set(want) == {"sem_seg", "panoptic", "center",
                                     "offset", "depth", "points"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("key", ["sem_seg", "panoptic"])
def test_labels_agree(frames, key):
    got, want = frames
    assert (got[key] == want[key]).mean() >= AGREE


@pytest.mark.parametrize("key", ["center", "offset"])
def test_heads_close(frames, key):
    got, want = frames
    np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("key", ["depth", "points"])
def test_depth_close(frames, key):
    got, want = frames
    same = got["panoptic"] == want["panoptic"]
    g, w = got[key][same], want[key][same]
    assert np.isfinite(w).any() and (np.abs(w) > 0).any()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
