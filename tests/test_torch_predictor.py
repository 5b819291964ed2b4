"""The port's ``Predictor`` against ``mgnet_tpu.inference.predictor``.

One flax-initialised model at the narrow widths of test_torch_fused.py
(BN redrawn, and the road class's predictor column swapped with the most
common class's, so that DGC finds a ground), float32, carried across by
``load_jax_params``; the JAX ``Predictor`` gets the same weights through
``params``/``batch_stats``. Frames resize 80x160 images to 64x128; TTA
resizes 40x80 to 32x64. The JAX side compiles the frame twice (one image
with a camera, a batch of two without) and TTA once. Stated bars:
* sem_seg and panoptic: equal on >= 99.9% of pixels (the JAX CPU
  clustering evaluates |p - c|^2, the port c^2 - 2 p.c, which round apart
  at near ties; an argmax near-tie may flip a class);
* center, offset: 1e-4 abs and rel; depth and points the same where the
  panoptic maps agree (the depth filters read them);
* the resize and the co-augmented camera: equal to the JAX mapper's.
The weight loading, the output filter and the metadata fallback are held
to the JAX class's semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgnet_tpu.config import get_default_config as jax_config
from mgnet_tpu.data.mapper import TestDatasetMapper as JTestDatasetMapper
from mgnet_tpu.inference.predictor import Predictor as JPredictor
from mgnet_tpu.models.mgnet import build_model as j_build_model
from mgnet_tpu.utils.weights import flatten_params, unflatten_params

from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.inference import Predictor
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.utils import load_jax_params, save_params
from test_torch_fused import _configure  # tests/ is on sys.path
from test_torch_models import randomized

ATOL = RTOL = 1e-4
AGREE = 0.999
ROAD, COMMON = 1, 16  # trainIds: road, and the class random heads favour
CALIB = {"intrinsic": {"fx": 90.0, "fy": 91.0, "u0": 79.5, "v0": 39.5},
         "extrinsic": {"baseline": 0.2, "z": 1.3}}
K0 = np.array([[110.0, 0, 75.0], [0, 108.0, 41.0], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(cfg, tta=False):
    _configure(cfg)
    cfg.MODEL.WEIGHTS = ""
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = \
        (32, 64) if tta else (64, 128)
    cfg.TEST.MSC_FLIP_EVAL = tta
    return cfg


def _images(seed, n, h, w):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for _ in range(n)]


@pytest.fixture(scope="module")
def weights():
    """(flax variables, their flat arrays) of the narrow model."""
    jmodel = j_build_model(_cfg(jax_config()))
    init = jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(0), x,
                                         train=False))
    variables = randomized(init(jnp.zeros((1, 64, 128, 3))), 7)
    params = flatten_params(variables["params"])
    key = "sem_seg_head/head/predictor/kernel"
    kernel = params[key].copy()
    kernel[..., [ROAD, COMMON]] = kernel[..., [COMMON, ROAD]]
    params[key] = kernel
    variables = {"params": unflatten_params(variables["params"], params),
                 "batch_stats": variables["batch_stats"]}
    return variables, {**params, **flatten_params(variables["batch_stats"])}


def _port_model(flat, cfg):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(load_jax_params(flat, model))
    return model


def _pair(weights, name, tta=False, calib=None):
    variables, flat = weights
    jp = JPredictor(_cfg(jax_config(), tta),
                    params={"model": variables["params"]},
                    batch_stats=variables["batch_stats"],
                    calibration_info=calib, dataset_name=name)
    cfg = _cfg(get_default_config(), tta)
    tp = Predictor(cfg, model=_port_model(flat, cfg), calibration_info=calib,
                   dataset_name=name, device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def frames(weights):
    """The two JAX frame compiles and the predictors they came from: one
    80x160 image with the calibration (and again with K0 and no height,
    the same executable), and the JAX-resized batch of two without a
    camera."""
    imgs = _images(3, 2, 80, 160)
    jp, tp = _pair(weights, "predictor_calib", calib=CALIB)
    with_calib = jp(imgs[0])
    with_k0 = jp(imgs[0], camera_matrix=K0)
    jb, tb = _pair(weights, "predictor_batch")
    batch = np.stack([jb.mapper._resize(80, 160).apply_image(i)
                      for i in imgs]).astype(np.float32)
    return dict(imgs=imgs, batch=batch, jp=jp, tp=tp, tb=tb,
                with_calib=with_calib, with_k0=with_k0,
                batch_out=jb.predict_batch(batch))


def _assert_agree(got, want):
    """The bars of the module docstring; ``got`` and ``want`` numpy dicts
    with the same keys (a jitted JAX function returns them sorted)."""
    assert sorted(got) == sorted(want)
    same = None
    for k in ("sem_seg", "panoptic"):
        if k in want:
            assert got[k].shape == want[k].shape, k
            assert (got[k] == want[k]).mean() >= AGREE, k
    if "panoptic" in want:
        same = got["panoptic"] == want["panoptic"]
    for k in ("center", "offset", "depth", "points"):
        if k not in want:
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k in ("depth", "points") and same is not None:
            g, w = g[same], w[same]
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)


def test_call_with_calibration_matches_jax(frames):
    got = frames["tp"](frames["imgs"][0])
    want = frames["with_calib"]
    assert list(got) == ["sem_seg", "panoptic", "center", "offset",
                         "depth", "points"]
    assert got["panoptic"].shape == (64, 128)
    # DGC found its ground: the depth is scaled, not all 0
    assert (got["panoptic"] // 1000 == ROAD).mean() > 0.1
    assert np.isfinite(got["depth"]).all() and got["depth"].max() > 0
    _assert_agree(got, want)


def test_call_with_a_camera_matrix_and_no_height_uses_one(frames):
    tp, img = frames["tp"], frames["imgs"][0]
    got = tp(img, camera_matrix=K0)
    _assert_agree(got, frames["with_k0"])
    for k, v in tp(img, camera_matrix=K0, camera_height=1.0).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_call_without_calibration_matches_jax(frames):
    """Without a camera: no DGC, no points; against row 0 of the JAX
    batch (the same frame on the same resized image)."""
    got = frames["tb"](frames["imgs"][0])
    want = {k: v[0] for k, v in frames["batch_out"].items()}
    assert "points" not in got
    _assert_agree(got, want)


def test_prepare_resizes_and_moves_the_camera_as_jax(frames):
    tp, img = frames["tp"], frames["imgs"][1]
    resized, K, height = tp.prepare(img)
    t = JTestDatasetMapper(frames["jp"].cfg)._resize(80, 160)
    np.testing.assert_array_equal(
        resized, t.apply_image(img).astype(np.float32))
    intr = CALIB["intrinsic"]
    oc = t.apply_coords(np.array([[intr["u0"], intr["v0"]]]))
    fl = t.apply_focal(np.array([[intr["fx"], intr["fy"]]]))
    np.testing.assert_array_equal(K, np.array(
        [[fl[0, 0], 0, oc[0, 0]], [0, fl[0, 1], oc[0, 1]], [0, 0, 1]],
        np.float32))
    assert height == CALIB["extrinsic"]["z"]
    assert frames["tb"].prepare(img)[1:] == (None, None)


def test_predict_batch_matches_jax(frames):
    got = frames["tb"].predict_batch(frames["batch"])
    want = frames["batch_out"]
    for i in range(2):
        _assert_agree({k: v[i] for k, v in got.items()},
                      {k: v[i] for k, v in want.items()})


@pytest.mark.parametrize("outputs", [("panoptic",), ("depth",),
                                     ("center", "sem_seg"),
                                     ("points", "depth")])
def test_predict_batch_returns_only_what_was_asked(frames, outputs):
    """Each filtered call equals the full dict's entries bit for bit (the
    same weights and arithmetic on one device); the JAX full panoptic
    holds it to JAX; a request without depth keys runs a frame without
    the depth branch, and each key tuple keeps one frame."""
    tb, batch = frames["tb"], frames["batch"]
    cam = {}
    if "points" in outputs:
        cam = dict(camera_matrix=np.stack([K0, K0]),
                   camera_height=np.array([1.2, 1.5], np.float32))
    full = tb.predict_batch(batch, **cam)
    got = tb.predict_batch(batch, outputs=outputs, **cam)
    assert list(got) == list(outputs)
    for k in outputs:
        np.testing.assert_array_equal(got[k], full[k], err_msg=k)
    if "panoptic" in outputs:
        _assert_agree({"panoptic": got["panoptic"]},
                      {"panoptic": frames["batch_out"]["panoptic"]})
    filtered = tb._fused_filtered[tuple(outputs)]
    tb.predict_batch(batch, outputs=outputs, **cam)
    assert tb._fused_filtered[tuple(outputs)] is filtered
    # the frame behind the filter: with the depth branch only if asked
    computed = filtered.__defaults__[0](
        batch[:1], **{k: v[:1] for k, v in cam.items()})
    assert ("depth" in computed) == bool({"depth", "points"} & set(outputs))


def test_predict_batch_without_materialize_returns_tensors(frames):
    tb, batch = frames["tb"], frames["batch"]
    out = tb.predict_batch(batch, outputs=("panoptic",), materialize=False)
    assert isinstance(out["panoptic"], torch.Tensor)
    assert out["panoptic"].device.type == "cpu"
    np.testing.assert_array_equal(
        out["panoptic"].numpy(),
        tb.predict_batch(batch, outputs=("panoptic",))["panoptic"])


@pytest.mark.parametrize("outputs,match", [
    (("panoptic", "nonsense"), "not produced by this config"),
    (("points",), "requires camera_matrix"),
])
def test_predict_batch_rejects_as_jax(frames, outputs, match):
    """The same ValueError as the JAX class, before any work."""
    batch = frames["batch"]
    with pytest.raises(ValueError, match=match) as want:
        frames["jp"].predict_batch(batch, outputs=outputs)
    with pytest.raises(ValueError, match=match) as got:
        frames["tb"].predict_batch(batch, outputs=outputs)
    assert str(got.value) == str(want.value)


def test_tta_matches_jax(weights):
    """TEST.MSC_FLIP_EVAL: multi-scale + flip, argmax, fusion; the camera
    is ignored, as in the JAX class (no DGC, no filter, no points)."""
    img = _images(5, 1, 40, 80)[0]
    jp, tp = _pair(weights, "predictor_tta", tta=True, calib=CALIB)
    want = jp(img)
    got = tp(img)
    assert list(got) == ["panoptic", "sem_seg", "center", "offset", "depth"]
    assert got["panoptic"].shape == (32, 64)
    _assert_agree(got, want)
    unscaled = tp.predict_batch(tp.prepare(img)[0][None])
    for k, v in got.items():
        np.testing.assert_array_equal(v, unscaled[k][0], err_msg=k)
    assert "points" not in tp.available_outputs()


@pytest.fixture(scope="module")
def npz_path(weights, tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "narrow.npz"
    np.savez(path, **weights[1])
    return path


def _same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("suffix", [True, False])
def test_npz_weights_are_grafted(weights, npz_path, suffix):
    """MODEL.WEIGHTS or checkpoint_path an npz (the suffix may be left
    out): every leaf lands, so the model equals the carried one."""
    cfg = _cfg(get_default_config())
    path = str(npz_path) if suffix else str(npz_path)[:-len(".npz")]
    p = Predictor(cfg, checkpoint_path=path, dataset_name="predictor_npz",
                  device="cpu")
    _same_state(p.model, _port_model(weights[1], cfg))
    cfg.MODEL.WEIGHTS = path
    _same_state(Predictor(cfg, dataset_name="predictor_npz",
                          device="cpu").model, p.model)


def test_npz_matching_nothing_raises(tmp_path):
    path = tmp_path / "other.npz"
    np.savez(path, **{"nowhere/kernel": np.zeros((1, 1, 3, 4), np.float32)})
    cfg = _cfg(get_default_config())
    with pytest.raises(ValueError, match="matched zero"):
        Predictor(cfg, checkpoint_path=str(path), device="cpu")


def test_model_final_directory_is_loaded(weights, tmp_path):
    cfg = _cfg(get_default_config())
    model = _port_model(weights[1], cfg)
    save_params(str(tmp_path / "model_final"), model)
    cfg.MODEL.WEIGHTS = str(tmp_path / "model_final")
    _same_state(Predictor(cfg, device="cpu").model, model)


def test_without_weights_the_seeded_draw_stands():
    cfg = _cfg(get_default_config())
    cfg.SEED = 3
    want = build_model(cfg, device="cpu")
    init_random_(want, torch.Generator().manual_seed(3))
    _same_state(Predictor(cfg, device="cpu").model, want)


@pytest.mark.parametrize("num_classes", [20, 19])
def test_metadata_fallback_matches_jax(weights, num_classes):
    """An unregistered dataset gets the category table of the model's
    class count: the same statics as the JAX class."""
    name = f"predictor_unregistered_{num_classes}"
    jcfg = _cfg(jax_config())
    cfg = _cfg(get_default_config())
    for c in (jcfg, cfg):
        c.MODEL.SEM_SEG_HEAD.NUM_CLASSES = num_classes
    jp = JPredictor(jcfg, params={"model": {}}, batch_stats={},
                    dataset_name=name)
    tp = Predictor(cfg, dataset_name=name, device="cpu")
    # every field but the JAX one that picks its TPU kernel
    assert tp.statics._asdict() == {
        k: v for k, v in jp.statics._asdict().items()
        if k != "use_pallas_fusion"}
    assert tp.statics.num_classes == num_classes


def test_entry_point_defaults_to_the_card():
    """No device given: the model goes to 'cuda', which this CPU-only
    build refuses; nothing falls back to the CPU."""
    cfg = _cfg(get_default_config())
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        Predictor(cfg, model=build_model(cfg, device="cpu"))
