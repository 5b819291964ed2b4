"""The port's bench and profile tools (mgnet_tpu_torch/tools/bench_*.py,
profile_*.py) and ``utils.profiling`` on the CPU, at tiny sizes.

Each tool's ``main`` runs once here with ``--device cpu`` (their times
are the host's, which says nothing of a card: the tools print that) and
its JSON is checked for the keys and the structure a card run reports:
profile_train's and profile_fused_roofline's rows sum to the full step
and frame, each kernel's launches are counted (none here: on the CPU the
plain versions run). The surrogates of profile_train equal the JAX
tool's ``_surrogate_grid_sample`` and ``_l1_residual_planar`` on seeded
inputs, run eagerly from their source in ``tools/profile_train.py``
(loaded with ``ast``: that module sets JAX's compilation cache at
import).
"""

from __future__ import annotations

import ast
import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgnet_tpu_torch.tools import (
    bench_dataloader,
    bench_eval_loop,
    bench_mapper,
    bench_train,
    profile_fused_roofline,
    profile_inference,
    profile_model,
    profile_postproc,
    profile_train,
)
from mgnet_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
NARROW = ["MODEL.GCM.GCM_CHANNELS", "32",
          "MODEL.SEM_SEG_HEAD.ARM_CHANNELS", "[32, 32]",
          "MODEL.SEM_SEG_HEAD.REFINE_CHANNELS", "[32, 32]",
          "MODEL.SEM_SEG_HEAD.FFM_CHANNELS", "48",
          "MODEL.SEM_SEG_HEAD.HEAD_CHANNELS", "32"]
TOOLS = [bench_train, bench_eval_loop, bench_mapper, bench_dataloader,
         profile_train, profile_model, profile_postproc, profile_inference,
         profile_fused_roofline]
DEVICE_TOOLS = [t for t in TOOLS if t not in (bench_mapper,
                                              bench_dataloader)]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _last_json(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_bench_train(capsys):
    res = bench_train.main(["--device", "cpu", "--batch", "2", "--size",
                            "64", "--iters", "1", *NARROW,
                            "MODEL.COMPUTE_DTYPE", "float32"])
    assert _last_json(capsys) == json.loads(json.dumps(res))
    assert res["value"] > 0 and np.isfinite(res["loss_total"])
    assert res["launches_per_step"] == dict.fromkeys(bench_train.KERNELS, 0)
    assert res["peak_gib"] is None and res["device"] == "cpu"


def test_bench_train_accumulates_and_rematerialises(capsys):
    res = bench_train.main(["--device", "cpu", "--batch", "2", "--size",
                            "64", "--iters", "1", "--accum", "2", "--remat",
                            "--no-depth", *NARROW])
    assert res["accum"] == 2 and np.isfinite(res["loss_total"])


def test_bench_eval_loop_reports_both_passes_and_host_bytes(capsys):
    res = bench_eval_loop.main([
        "--device", "cpu", "--images", "2", "--height", "64", "--width",
        "128", "--batch", "2", "--workers", "0", *NARROW,
        "MODEL.COMPUTE_DTYPE", "float32"])
    assert set(res["passes"]) == {"cold", "steady"}
    # uint8 classes, int16 panoptic, float16 center and depth a pixel
    for p in res["passes"].values():
        assert p["host_bytes_per_image"] == 64 * 128 * (1 + 2 + 2 + 2)
        assert p["images_per_s"] > 0
    assert _last_json(capsys)["metric"] == "eval_loop_images_per_s"


def test_bench_mapper_times_every_phase(capsys):
    res = bench_mapper.main(["--height", "128", "--width", "256",
                             "--iters", "1"])
    assert list(res["phases_ms"]) == ["decode 4 PNG", "geometric x3+label",
                                      "color jitter x3", "targets"]
    assert res["value"] > 0 and res["step_seconds"] == bench_mapper.\
        STEP_SECONDS
    assert res["cores_for_batch"] == pytest.approx(
        12 * res["value"] / 1e3 / bench_mapper.STEP_SECONDS, rel=0.01)


def test_bench_dataloader_holds_the_host_library_to_numpy(capsys):
    res = bench_dataloader.main(["--height", "64", "--width", "128",
                                 "--iters", "1", "--threads", "1,2"])
    assert len(res["rows_ms"]) == 8
    assert set(res["threaded_read_png_img_per_s"]) == {1, 2}


@pytest.fixture(scope="module")
def ledger():
    return profile_train.main([
        "--device", "cpu", "--batch", "2", "--size", "64", "--iters", "1",
        "--roofline", *NARROW, "MODEL.COMPUTE_DTYPE", "float32"])


def test_profile_train_rows_sum_to_the_full_step(ledger):
    assert list(ledger["ledger_ms"]) == profile_train.LEDGER
    assert sum(ledger["ledger_ms"].values()) == pytest.approx(
        ledger["full_step_ms"], abs=1e-3)
    assert ledger["ledger_sum_ms"] == pytest.approx(ledger["full_step_ms"],
                                                    abs=1e-3)
    rows = profile_train.ledger([10.0, 8.0, 7.5, 4.0, 3.0, 1.0])
    assert sum(rows.values()) == 10.0 and rows[profile_train.LEDGER[-1]] \
        == 1.0


def test_profile_train_roofline_counts_flops_not_bytes(ledger):
    roof = ledger["roofline"]
    assert set(roof) == set(profile_train.LEDGER) | {"FULL STEP"}
    assert roof["FULL STEP"]["gflops"] > 0
    assert all(set(r) == {"gflops", "peak_share_pct"} for r in roof.values())
    # the surrogates remove no matrix product
    assert roof[profile_train.LEDGER[0]]["gflops"] == 0.0
    assert ledger["peak_tflops"] == 989.0


def test_profile_train_restores_the_patched_modules(ledger):
    import mgnet_tpu_torch.geometry.camera_utils as cu
    import mgnet_tpu_torch.losses.photometric as ph
    from mgnet_tpu_torch.geometry.image import grid_sample_planar
    from mgnet_tpu_torch.ops.ssim import fused_photometric_residual

    assert cu.grid_sample_planar is grid_sample_planar
    assert ph.fused_photometric_residual is fused_photometric_residual
    assert list(ledger["launches_per_step"]) == [
        v[0] for v in profile_train.VARIANTS]


def _jax_function(name: str):
    """A function of tools/profile_train.py (the JAX tool), compiled from
    its source with ``jnp`` in scope."""
    tree = ast.parse((ROOT / "tools" / "profile_train.py").read_text())
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    scope = {"jnp": jnp}
    exec(compile(ast.Module([node], []), "profile_train.py", "exec"), scope)
    return scope[name]


def test_surrogate_warp_equals_the_jax_tools():
    rng = np.random.RandomState(0)
    image = rng.rand(2, 16, 24, 3).astype(np.float32)     # NHWC
    coords = rng.uniform(-1.2, 1.2, (2, 16, 24, 2)).astype(np.float32)
    want = np.asarray(_jax_function("_surrogate_grid_sample")(
        jnp.asarray(image), jnp.asarray(coords)))
    got = profile_train._surrogate_grid_sample(
        torch.from_numpy(image).permute(0, 3, 1, 2), torch.from_numpy(coords))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-7)


def test_l1_residual_equals_the_jax_tools():
    rng = np.random.RandomState(1)
    warped = rng.rand(2, 3, 16, 24).astype(np.float32)
    image = rng.rand(2, 3, 16, 24).astype(np.float32)
    want = np.asarray(_jax_function("_l1_residual_planar")(
        jnp.asarray(warped.reshape(6, 16, 24)),
        jnp.asarray(image.reshape(6, 16, 24)), 0.85, 2))
    got = profile_train._l1_residual_planar(torch.from_numpy(warped),
                                            torch.from_numpy(image))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


def test_profile_model_times_each_stage(capsys):
    res = profile_model.main(["--device", "cpu", "--h", "64", "--w", "128",
                              "--iters", "1", *NARROW])
    assert len(res["stages_ms"]) == 6
    assert all(v > 0 for v in res["stages_ms"].values())


def test_profile_postproc_counts_the_clustering(capsys, tmp_path):
    res = profile_postproc.main(["--device", "cpu", "--h", "64", "--w",
                                 "128", "--iters", "1", "--k", "16",
                                 "--trace", str(tmp_path / "trace")])
    assert len(res["stages_ms"]) == 11
    assert set(res["center_argmin_launches_per_call"]) == {
        "cluster_kernel", "fusion_full"}
    assert (tmp_path / "trace" / "trace.json").is_file()


def test_profile_inference_frame_and_tta(capsys):
    res = profile_inference.main(["--device", "cpu", "--height", "64",
                                  "--width", "128", "--iters", "1"])
    assert len(res["stages_ms"]) == 6
    assert set(res["center_argmin_launches_per_call"]) == {
        "panoptic fusion", "full fused pipeline"}
    tta = profile_inference.main(["--device", "cpu", "--height", "32",
                                  "--width", "64", "--iters", "1", "--tta",
                                  "--tta-batch", "1"])
    assert tta["metric"] == "tta_step_ms" and tta["value"] > 0


def test_profile_fused_roofline_rows_sum_to_the_frame(capsys):
    res = profile_fused_roofline.main(["--device", "cpu", "--height", "64",
                                       "--width", "128", "--iters", "1"])
    assert len(res["rows"]) == 5
    assert res["ledger_sum_ms"] == pytest.approx(res["full_ms"], abs=1e-3)
    assert all("gb" not in r for r in res["rows"])
    assert res["peak_tflops"] == 989.0
    # the depth branch's row holds its convolutions
    assert res["rows"][1]["gflop"] > 0
    assert res["rows"][-1]["gflop"] > 0


@pytest.mark.parametrize("tool", DEVICE_TOOLS,
                         ids=lambda t: t.__name__.split(".")[-1])
def test_tools_default_to_the_card_and_refuse_without_one(tool):
    assert tool.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tool.main([])


def test_trace_writes_a_chrome_trace_and_a_table(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(4) + 1
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    assert "Name" in (tmp_path / "t" / "kernels.txt").read_text()
    with profiling.trace(None):
        pass
    with profiling.trace(""):
        pass
    assert sorted(os.listdir(tmp_path)) == ["t"]


def test_count_flops_counts_a_convolution():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
    x = torch.ones(2, 3, 10, 12)
    assert profiling.count_flops(lambda: conv(x)) == 2 * 2 * 8 * 10 * 12 \
        * 3 * 3 * 3


def test_peaks_are_the_h100s():
    assert profiling.PEAK_BF16_FLOPS == 989e12
    assert "not a card" in profiling.device_line("cpu")
