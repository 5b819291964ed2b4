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
def setup():
    """One flax-initialised model on both sides, the statics with the most
    common stuff class as the DGC ground, and the inputs."""
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

    # random heads rarely predict road: let the most common stuff class
    # stand in as the ground, so that the DGC median sees pixels
    fn = build_fused_inference(model, statics, cfg.MODEL.PIXEL_MEAN,
                               cfg.MODEL.PIXEL_STD, device="cpu")
    pan = fn(image, K, height)["panoptic"].numpy()
    stuff = pan[(pan >= 0) & (pan % 1000 == 0)]
    road = int(np.bincount(stuff // 1000).argmax()) * 1000
    return dict(cfg=cfg, model=model, jmodel=jmodel,
                variables=({"model": params}, stats),
                statics=statics._replace(road_class_id=road),
                jstatics=jstatics._replace(road_class_id=road),
                inputs=(image, K, height))


def _frames(setup, jit=True, use_dgc=True, with_camera=True, **options):
    """The port's and the JAX frame's outputs with the given options."""
    cfg = setup["cfg"]
    image, K, height = setup["inputs"]
    camera = (K, height) if with_camera else ()
    fn = build_fused_inference(
        setup["model"], setup["statics"]._replace(use_dgc=use_dgc),
        cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, device="cpu", **options)
    got = {k: v.numpy() for k, v in fn(image, *camera).items()}
    jfn = j_build_fused(setup["jmodel"],
                        setup["jstatics"]._replace(use_dgc=use_dgc),
                        cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, **options)
    want = {k: np.asarray(v) for k, v in (jax.jit(jfn) if jit else jfn)(
        *setup["variables"], jnp.asarray(image),
        *(jnp.asarray(a) for a in camera)).items()}
    return got, want


@pytest.fixture(scope="module")
def frames(setup):
    return _frames(setup)


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


# the frame's options, each against the JAX frame (run eagerly) with the
# same options: (options, the output keys)
VARIANTS = {
    "panoptic_only": (dict(with_depth=False),
                      {"sem_seg", "panoptic", "center", "offset"}),
    "depth_only_no_camera": (dict(with_panoptic=False, with_camera=False),
                             {"depth"}),
    "no_dgc": (dict(use_dgc=False),
               {"sem_seg", "panoptic", "center", "offset", "depth"}),
    "no_point_cloud": (dict(return_point_cloud=False),
                       {"sem_seg", "panoptic", "center", "offset", "depth"}),
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request, setup):
    options, keys = VARIANTS[request.param]
    return request.param, keys, _frames(setup, jit=False, **options)


def test_frame_options_match_jax(variant, frames):
    """Key sets, shapes and dtypes; labels on >= 99.9% of pixels; the
    continuous outputs within the file's bars where the panoptic maps
    agree. Without DGC or a camera the depth is the unscaled network
    depth, which the filters zero only where the frame has panoptic."""
    name, keys, (got, want) = variant
    assert set(got) == set(want) == keys
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    same = np.ones(want["depth" if "depth" in want else "sem_seg"].shape,
                   bool)
    if "panoptic" in want:
        for k in ("sem_seg", "panoptic"):
            assert (got[k] == want[k]).mean() >= AGREE, k
        same = got["panoptic"] == want["panoptic"]
        for k in ("center", "offset"):
            np.testing.assert_allclose(got[k], want[k], atol=ATOL,
                                       rtol=RTOL, err_msg=k)
    if "depth" in want:
        g, w = got["depth"][same], want["depth"][same]
        assert (w > 0).any()
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
    full_got, full_want = frames
    if name == "no_point_cloud":
        # the same DGC-scaled, filtered depth as the full frame's
        np.testing.assert_array_equal(got["depth"], full_got["depth"])
    if name in ("no_dgc", "depth_only_no_camera"):
        # unscaled: not the full frame's DGC depth
        assert not np.allclose(got["depth"][same], full_want["depth"][same])
    if name == "depth_only_no_camera":
        assert (got["depth"] > 0).all()


def test_frame_branches_default_to_the_model(setup):
    """Without with_panoptic/with_depth the frame takes the model's own
    branches; asking for a branch the model lacks raises."""
    cfg = _configure(get_default_config())
    cfg.WITH_DEPTH = False
    model = build_model(cfg, device="cpu")
    image, K, height = setup["inputs"]
    fn = build_fused_inference(model, setup["statics"], cfg.MODEL.PIXEL_MEAN,
                               cfg.MODEL.PIXEL_STD, device="cpu")
    assert set(fn(image, K, height)) == {"sem_seg", "panoptic", "center",
                                         "offset"}
    with pytest.raises(ValueError, match="with_depth=True"):
        build_fused_inference(model, setup["statics"], cfg.MODEL.PIXEL_MEAN,
                              cfg.MODEL.PIXEL_STD, with_depth=True,
                              device="cpu")
