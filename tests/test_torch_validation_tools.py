"""The port's overfit validations against the JAX package's tools, on the CPU.

* ``utils.blur.gaussian_blur`` against ``cv2.GaussianBlur(x, (0, 0), s)``
  on float32 noise of the depth tool's shapes (128 x (width + 32) x 3 at
  widths 256 and 512), for the three octaves 1.5, 6 and 24 (193 taps,
  wider than the 128 rows: the reflect-101 border folds more than once):
  within 1e-6 absolute. The taps against ``cv2.getGaussianKernel`` and the
  border against ``cv2.borderInterpolate``.
* The depth tool's texture and two-plane frames against the JAX tool's
  (``tools/validate_depth_overfit.py``, cv2 there) within 1e-5; the scene
  trees of both tools against the JAX tools' (Pillow there): the same
  files, equal JSON, and PNGs that decode equal (the depth scenes' images
  within 1 grey level, where the blur's last bit moves a rounding).
* ``Adam`` against ``optax.adam`` run eagerly (no jit) for 50 steps.
* A few steps of each tool at the smallest size through ``main([...,
  "--device", "cpu"])``: ``validate_overfit --steps 2`` (with narrow heads
  patched into its config) and
  ``validate_depth_overfit --mode gt_pose|gt_depth --steps 3``. They check
  that the tools run and print their result lines, not the gates, which
  run on the card (chip_smoke.py).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import re
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from mgnet_tpu_torch.tools import validate_depth_overfit as tdepth
from mgnet_tpu_torch.tools import validate_overfit as toverfit
from mgnet_tpu_torch.utils.blur import (
    gaussian_blur,
    gaussian_kernel,
    reflect_101,
)

ROOT = Path(__file__).resolve().parent.parent
SIGMAS = (1.5, 6.0, 24.0)
WIDTHS = (256, 512)
NARROW = ["MODEL.GCM.GCM_CHANNELS", "32"] + [
    item for head in ("SEM_SEG_HEAD", "INS_EMBED_HEAD")
    for item in (f"MODEL.{head}.ARM_CHANNELS", "[32, 32]",
                 f"MODEL.{head}.REFINE_CHANNELS", "[32, 32]",
                 f"MODEL.{head}.FFM_CHANNELS", "48",
                 f"MODEL.{head}.HEAD_CHANNELS", "32")]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jdepth():
    return _jax_tool("validate_depth_overfit")


@pytest.fixture(scope="module")
def joverfit():
    return _jax_tool("validate_overfit")


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("sigma", SIGMAS)
def test_blur_equals_cv2(sigma, width):
    x = np.random.RandomState(int(sigma * 10) + width).rand(
        128, width + 32, 3).astype(np.float32)
    got = gaussian_blur(x, sigma)
    want = cv2.GaussianBlur(x, (0, 0), sigma)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("sigma", SIGMAS)
def test_gaussian_taps_equal_cv2s(sigma):
    got = gaussian_kernel(sigma)
    n = int(round(sigma * 8 + 1)) | 1
    want = cv2.getGaussianKernel(n, sigma, cv2.CV_32F)[:, 0]
    assert got.shape == (n,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 5, 128])
def test_reflect_101_equals_cv2_border_interpolate(n):
    index = np.arange(-300, 300 + n)
    want = [cv2.borderInterpolate(int(i), n, cv2.BORDER_REFLECT_101)
            for i in index]
    np.testing.assert_array_equal(reflect_101(index, n), want)


@pytest.mark.parametrize("width", WIDTHS)
def test_texture_matches_the_jax_tools(jdepth, width):
    got = tdepth.texture(seed=9, width=width)
    want = jdepth._texture(seed=9, width=width)
    assert got.shape == want.shape == (128, width + 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("width", WIDTHS)
def test_analytic_frames_match_the_jax_tools(jdepth, width):
    got = tdepth.analytic_frames(width)
    want = jdepth._analytic_frames(width)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(g, w)


def test_constants_are_the_jax_tools(jdepth, joverfit):
    for name in ("H", "W", "FX", "BASELINE", "DEPTH_TOP", "DEPTH_BOTTOM",
                 "PLANE_SHIFTS", "PLANE_DEPTHS", "N_SCENES"):
        assert getattr(tdepth, name) == getattr(jdepth, name), name
    assert toverfit.N_SCENES == joverfit.N_SCENES == 6


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def _compare_trees(got_root, want_root, image_slack=0):
    files = _tree(got_root)
    assert files == _tree(want_root)
    for rel in files:
        g, w = Path(got_root, rel), Path(want_root, rel)
        if rel.endswith(".json"):
            assert json.loads(g.read_text()) == json.loads(w.read_text()), rel
            continue
        a, b = np.asarray(Image.open(g)), np.asarray(Image.open(w))
        assert a.shape == b.shape and a.dtype == b.dtype, rel
        if image_slack and "leftImg8bit" in rel:
            diff = np.abs(a.astype(int) - b.astype(int))
            assert diff.max() <= image_slack, rel
            assert (diff == 0).mean() >= 0.999, rel
        else:
            np.testing.assert_array_equal(a, b, err_msg=rel)
    return files


def test_overfit_scenes_equal_the_jax_tools(joverfit, tmp_path):
    toverfit.make_dataset(str(tmp_path / "port"))
    joverfit.make_dataset(str(tmp_path / "jax"))
    files = _compare_trees(tmp_path / "port", tmp_path / "jax")
    assert len(files) == 6 * 6 + 1


def test_depth_scenes_match_the_jax_tools(jdepth, tmp_path):
    tdepth.make_dataset(str(tmp_path / "port"))
    jdepth.make_dataset(str(tmp_path / "jax"))
    files = _compare_trees(tmp_path / "port", tmp_path / "jax",
                           image_slack=1)
    assert len(files) == 6 * 7 + 1


def test_adam_equals_optax(tmp_path):
    rng = np.random.RandomState(0)
    p0 = rng.randn(2, 3, 5).astype(np.float32)
    tx = optax.adam(3e-2)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    tp = torch.from_numpy(p0.copy())
    opt = tdepth.Adam(3e-2, tp)
    for _ in range(50):
        g = rng.randn(*p0.shape).astype(np.float32)
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step(tp, torch.from_numpy(g))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)


def _run(main, argv):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = main(argv)
    return rc, printed.getvalue()


@pytest.fixture(scope="module")
def overfit_run():
    """Two steps of the tool on the CPU with narrow heads (its recipe's
    config, then NARROW)."""
    recipe = toverfit.overfit_config

    def narrow(*args):
        cfg = recipe(*args)
        cfg.merge_from_list(NARROW)
        return cfg

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(toverfit, "overfit_config", narrow)
        return _run(toverfit.main, ["--steps", "2", "--device", "cpu"])


def test_validate_overfit_runs_and_prints_its_results(overfit_run):
    rc, out = overfit_run
    assert rc in (0, 1)
    assert re.search(r"\{'iteration': 1, .*'loss_total': ", out)
    body = out[out.index("{\n"):out.index("OVERFIT VALIDATION")]
    result = json.loads(body)
    assert list(result) == ["PQ", "PQ_things", "PQ_stuff", "mIoU"]
    assert all(np.isfinite(v) for v in result.values())
    assert out.rstrip().endswith(
        "OVERFIT VALIDATION: " + ("PASS" if rc == 0 else "FAIL"))


@pytest.fixture(scope="module")
def ablations():
    return {mode: _run(tdepth.main, ["--mode", mode, "--steps", "3",
                                     "--device", "cpu"])
            for mode in ("gt_pose", "gt_depth")}


@pytest.mark.parametrize("mode", ["gt_pose", "gt_depth"])
def test_ablation_runs_and_prints_its_results(ablations, mode):
    rc, out = ablations[mode]
    lines = out.strip().splitlines()
    truth = float(lines[0].split("photometric at analytic truth: ")[1])
    assert 0 <= truth < 1e-3
    steps = [ln for ln in lines if ln.startswith("  step ")]
    assert [int(ln.split()[1]) for ln in steps] == [0, 1, 2]
    losses = [float(ln.split("photometric ")[1]) for ln in steps]
    assert all(np.isfinite(losses))
    assert lines[-2].startswith(f"{mode}: photometric ")
    assert lines[-1] == f"ABLATION {mode}: " + ("PASS" if rc == 0
                                                 else "FAIL")


def test_gt_pose_descends_in_its_first_steps(ablations):
    out = ablations["gt_pose"][1]
    losses = [float(ln.split("photometric ")[1])
              for ln in out.splitlines() if ln.startswith("  step ")]
    assert losses[2] < losses[1] < losses[0]


def test_tools_refuse_an_unknown_mode():
    with pytest.raises(SystemExit):
        tdepth.main(["--mode", "nope"])
    with pytest.raises(ValueError):
        tdepth.run_ablation("nope", 1, device="cpu")
