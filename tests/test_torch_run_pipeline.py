"""The port's runbook (mgnet_tpu_torch/tools/run_pipeline.py) on the
CPU.

One module fixture runs ``--smoke --stages prepare,init,train,eval
--device cpu`` in a subprocess (~50 s): the raw synthetic trees, the
real conversion, the fabricated torchvision-shaped weights through the
real converter, 3 training iterations of the Fine YAML at the smoke
sizes and the evaluation of model_final. Beside it: the JAX tool's
option lists and fabricated ``.pth``, bit for bit, read from
``tools/run_pipeline.py`` without running it; the module's imports (the
standard library only); and ``--stages all`` (pseudo labels, the
VideoSequence retrain, the KITTI leg), marked slow.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mgnet_tpu_torch.tools import convert_torchvision_weights
from mgnet_tpu_torch.tools import run_pipeline

ROOT = Path(__file__).resolve().parent.parent
STAGES = ["prepare", "init", "train", "eval"]


def _jax_tool():
    """The JAX runbook's module, loaded by path: its module level imports
    the standard library only (its main imports the JAX package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_run_pipeline", ROOT / "tools" / "run_pipeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")


def _pipeline(tmp: Path, *extra, timeout=900):
    argv = ["--smoke", "--device", "cpu", "--workers", "0",
            "--data-root", str(tmp / "data"), "--output-dir",
            str(tmp / "out"), "--weights-dir", str(tmp / "weights"), *extra]
    return subprocess.run(
        [sys.executable, "-m", "mgnet_tpu_torch.tools.run_pipeline", *argv],
        cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=timeout)


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    res = _pipeline(tmp, "--stages", ",".join(STAGES))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return tmp, res.stdout


@pytest.mark.parametrize("name", ["SMOKE_TRAIN_OPTS", "SMOKE_KITTI_OPTS",
                                  "TINY_RUN_OPTS"])
def test_option_lists_equal_the_jax_tools(name):
    assert getattr(run_pipeline, name) == getattr(_jax_tool(), name)


def test_fabricated_pth_equals_the_jax_tools(tmp_path):
    ours = torch.load(run_pipeline._fabricate_torchvision_pth(
        str(tmp_path / "port")), weights_only=True)
    theirs = torch.load(_jax_tool()._fabricate_torchvision_pth(
        str(tmp_path / "jax")), weights_only=True)
    assert list(ours) == list(theirs) and len(ours) == 100
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k


def test_module_imports_only_the_standard_library():
    """run_pipeline.py at module level: only the standard library (the
    stages import the port in their own processes)."""
    code = (
        "import importlib.util, sys\n"
        "before = set(sys.modules)\n"
        f"spec = importlib.util.spec_from_file_location('rp', "
        f"{str(ROOT / 'mgnet_tpu_torch' / 'tools' / 'run_pipeline.py')!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "new = {n.split('.')[0] for n in set(sys.modules) - before}\n"
        "print(sorted(new - set(sys.stdlib_module_names)))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


def test_smoke_pipeline_prints_pipeline_ok_with_each_stage(smoke):
    _, out = smoke
    last = [ln for ln in out.splitlines() if ln.startswith("PIPELINE OK")]
    assert len(last) == 1, out[-3000:]
    assert [s.split("[")[0] for s in
            last[0][len("PIPELINE OK: "):].split(" -> ")] == STAGES
    for stage in STAGES:
        assert f"stage {stage}: " in out


def test_smoke_init_npz_equals_the_converter(smoke, tmp_path):
    """The init stage's npz is the port's converter on the fabricated
    .pth, key for key and bit for bit."""
    tmp, _ = smoke
    weights = tmp / "weights"
    pth = weights / "smoke_resnet18.pth"
    assert pth.is_file()
    convert_torchvision_weights.main([
        "--backbone", str(pth), "--pose", str(pth),
        "--output", str(tmp_path / "ref.npz")])
    got = np.load(weights / "imagenet_weights.npz")
    want = np.load(tmp_path / "ref.npz")
    assert sorted(got.files) == sorted(want.files)
    assert any(k.startswith("pose_net/encoder/") for k in got.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_smoke_train_writes_model_final_and_eval_its_metrics(smoke):
    tmp, _ = smoke
    out = tmp / "out"
    assert (out / "model_final" / "params.pt").is_file()
    assert (out / "checkpoints").is_dir()
    last = json.loads((out / "metrics.json").read_text().splitlines()[-1])
    assert {"panoptic_seg", "depth"} <= set(last), list(last)
    assert np.isfinite(last["panoptic_seg"]["PQ"])


def test_smoke_prepare_converts_both_splits(smoke):
    tmp, _ = smoke
    gt = tmp / "data" / "cityscapes" / "gtFine"
    for split in ("train", "val"):
        ann = json.loads((gt / f"cityscapes_panoptic_{split}.json")
                         .read_text())
        pngs = sorted((gt / f"cityscapes_panoptic_{split}").glob("*.png"))
        assert len(ann["annotations"]) == len(pngs) > 0


def test_the_card_is_the_default_and_its_absence_raises():
    assert run_pipeline.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(SystemExit, match="no CUDA card"):
        run_pipeline.main(["--smoke", "--device", "cuda"])


@pytest.mark.slow
def test_all_stages_smoke(tmp_path):
    """--stages all: Fine -> pseudo labels (curated labels copied over) ->
    their conversion -> VideoSequence from model_final -> KITTI pseudo
    labels -> Eigen-Zhou training and its depth evaluation."""
    res = _pipeline(tmp_path, "--stages", "all", timeout=3600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "PIPELINE OK" in res.stdout
    out = str(tmp_path / "out")
    for sub in ("", "_video", "_kitti"):
        assert os.path.exists(os.path.join(out + sub, "model_final")), sub
    last = json.loads(Path(out + "_kitti", "metrics.json").read_text()
                      .splitlines()[-1])
    assert "depth" in last, list(last)
