"""The runbook's prerequisites in the port against the JAX package's, on the
CPU.

* ``data.synthetic.make_synthetic_cityscapes_raw`` and
  ``make_synthetic_kitti_raw`` (through ``write_png``) against the JAX
  functions (through Pillow), same arguments: the same files, every PNG
  decoding equal (8-bit RGB frames, 16-bit grey instanceIds, disparity and
  depth), JSON and text byte-equal.
* ``tools.convert_torchvision_weights`` against
  ``tools/convert_torchvision_weights.py`` on the fabricated torchvision
  ResNet-18 state_dict of ``tools/run_pipeline.py``: the same npz, key for
  key and bit for bit, with and without the pose encoder; the npz grafts
  into the port's training model.
* ``tools.prepare_cityscapes`` and ``tools.prepare_kitti_eigen`` against
  ``datasets/prepare_{cityscapes,kitti_eigen}.py`` (their pool replaced by
  a serial map) on the raw trees' instanceIds: equal JSON, panoptic PNGs
  that decode equal.
* ``tools.visualize_data`` against ``tools/visualize_data.py`` on a mini
  tree with the Fine YAML at 128x256: the same PNGs, decoding equal (the
  JAX side with its native image library off).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mgnet_tpu.data import catalog as jcatalog
from mgnet_tpu.data import native as jnative
from mgnet_tpu.data import synthetic as jsynthetic

import mgnet_tpu_torch.data as tdata
from mgnet_tpu_torch.data import (
    make_synthetic_cityscapes_raw,
    make_synthetic_kitti_raw,
    write_cityscapes_tree,
)
from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.data.image_io import write_png
from mgnet_tpu_torch.models import build_model
from mgnet_tpu_torch.tools import (
    convert_torchvision_weights,
    prepare_cityscapes,
    prepare_kitti_eigen,
    visualize_data,
)
from mgnet_tpu_torch.utils.weights import load_pretrained_npz

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "datasets"))
import prepare_cityscapes as jprep_cityscapes  # noqa: E402
import prepare_kitti_eigen as jprep_kitti  # noqa: E402

FINE = str(ROOT / "configs" / "MGNet-Cityscapes-Fine.yaml")
# each kind of file in the raw trees: the part of its path that marks it
KINDS = {
    "cityscapes": {"frames": "leftImg8bit/", "sequence":
                   "leftImg8bit_sequence/", "instanceIds": "_instanceIds.png",
                   "disparity": "disparity/", "camera": "camera/"},
    "kitti_eigen": {"frames": "image_02/data/", "depth": "groundtruth/",
                    "calib": "calib_cam_to_cam.txt",
                    "splits": "data_splits/"}}


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def _same_file(got: Path, want: Path, rel: str):
    if rel.endswith(".png"):
        a, b = np.asarray(Image.open(got)), np.asarray(Image.open(want))
        assert (a.shape, a.dtype) == (b.shape, b.dtype), rel
        np.testing.assert_array_equal(a, b, err_msg=rel)
    else:
        assert got.read_bytes() == want.read_bytes(), rel


@pytest.fixture(scope="module")
def raw_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    make_synthetic_cityscapes_raw(str(root / "port"))
    jsynthetic.make_synthetic_cityscapes_raw(str(root / "jax"))
    make_synthetic_kitti_raw(str(root / "port"))
    jsynthetic.make_synthetic_kitti_raw(str(root / "jax"))
    return root


def test_raw_trees_have_the_jax_trees_files(raw_trees):
    files = _files(raw_trees / "port")
    assert files == _files(raw_trees / "jax")
    # 2 Cityscapes frames x (frame, 3 sequence frames, instanceIds,
    # disparity, camera); 7 KITTI frames, a depth map, calib, 2 split lists
    assert len(files) == 2 * 7 + 7 + 1 + 1 + 2


@pytest.mark.parametrize("dataset,kind", [
    (d, k) for d, kinds in KINDS.items() for k in kinds])
def test_raw_tree_files_equal_the_jax_trees(raw_trees, dataset, kind):
    rels = [r for r in _files(raw_trees / "port")
            if r.startswith(dataset + "/") and KINDS[dataset][kind] in r]
    assert rels
    for rel in rels:
        _same_file(raw_trees / "port" / rel, raw_trees / "jax" / rel, rel)


def test_raw_instance_ids_are_16_bit(raw_trees):
    rel = next(r for r in _files(raw_trees / "port")
               if r.endswith("_instanceIds.png"))
    ids = np.asarray(Image.open(raw_trees / "port" / rel))
    assert ids.dtype == np.uint16
    assert set(np.unique(ids)) == {7, 26000}


@pytest.fixture(scope="module")
def torchvision_pth(tmp_path_factory):
    root = tmp_path_factory.mktemp("pth")
    return _jax_tool("run_pipeline")._fabricate_torchvision_pth(str(root))


def _convert_both(pth, tmp_path, monkeypatch, *extra):
    got, want = tmp_path / "port.npz", tmp_path / "jax.npz"
    with contextlib.redirect_stdout(io.StringIO()):
        assert convert_torchvision_weights.main(
            ["--backbone", pth, *extra, "--output", str(got)]) == 0
        monkeypatch.setattr(sys, "argv", [
            "convert_torchvision_weights.py", "--backbone", pth, *extra,
            "--output", str(want)])
        _jax_tool("convert_torchvision_weights").main()
    return np.load(got), np.load(want)


@pytest.mark.parametrize("with_pose", [False, True])
def test_converter_equals_the_jax_tool(torchvision_pth, tmp_path,
                                       monkeypatch, with_pose):
    extra = ["--pose", torchvision_pth] if with_pose else []
    got, want = _convert_both(torchvision_pth, tmp_path, monkeypatch,
                              *extra)
    assert sorted(got.files) == sorted(want.files)
    assert len(got.files) == (2 if with_pose else 1) * 100
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if with_pose:
        stem = got["pose_net/encoder/stem/conv1/conv/kernel"]
        assert stem.shape == (7, 7, 9, 64)
        for i in range(3):
            np.testing.assert_array_equal(
                stem[:, :, 3 * i:3 * i + 3],
                got["backbone/stem/conv1/conv/kernel"] / 3)


def test_converted_npz_grafts_into_the_training_model(torchvision_pth,
                                                      tmp_path, monkeypatch):
    got, _ = _convert_both(torchvision_pth, tmp_path, monkeypatch,
                           "--pose", torchvision_pth)
    model = build_model(get_default_config(), device="cpu",
                        for_training=True)
    info = load_pretrained_npz(str(tmp_path / "port.npz"), model)
    assert info == {"matched": 200, "skipped": 0}
    w = model.state_dict()["backbone.res3_block0.conv1.conv.weight"]
    np.testing.assert_array_equal(
        w.numpy(), got["backbone/res3_block0/conv1/conv/kernel"]
        .transpose(3, 2, 0, 1))


class _Serial:
    """Stands in for ``multiprocessing.Pool`` in the JAX converters."""

    def __init__(self, workers):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, jobs):
        return [fn(j) for j in jobs]


def _kitti_instance_ids(raw: Path):
    """Pseudo-label instanceIds beside each KITTI frame of the raw tree
    (``label_02/data/<frame>_instanceIds.png``), as the pseudo-label tool
    writes them: road, sky and a car per frame."""
    out = raw / "pseudo"
    for i, img in enumerate(sorted(raw.rglob("image_02/data/*.png"))):
        rel = img.relative_to(raw / "kitti_eigen").parent.parent
        dst = out / rel / "label_02" / "data" / f"{img.stem}_instanceIds.png"
        dst.parent.mkdir(parents=True, exist_ok=True)
        inst = np.full((96, 320), 7, np.uint16)
        inst[:30] = 23
        inst[40:70, 20 + 10 * i:80 + 10 * i] = 26001 + i
        write_png(str(dst), inst)
    return out


@pytest.mark.parametrize("dataset", ["cityscapes", "kitti_eigen"])
def test_prepare_clis_equal_the_jax_scripts(raw_trees, tmp_path,
                                            monkeypatch, dataset):
    raw = raw_trees / "port"
    if dataset == "cityscapes":
        inputs = raw / "cityscapes" / "gtFine" / "train"
        port, jax_script = prepare_cityscapes, jprep_cityscapes
    else:
        inputs = _kitti_instance_ids(raw)
        port, jax_script = prepare_kitti_eigen, jprep_kitti
    out = {k: tmp_path / k for k in ("port", "jax")}
    monkeypatch.setattr(jax_script, "Pool", _Serial)
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        assert port.main(["--input-dir", str(inputs), "--output-dir",
                          str(out["port"] / "pan"), "--json",
                          str(out["port"] / "pan.json"),
                          "--workers", "0"]) == 0
        jax_script.convert2panoptic(str(inputs), str(out["jax"] / "pan"),
                                    str(out["jax"] / "pan.json"), 1)
    assert printed.getvalue().count("Converted") == 2
    files = _files(out["port"])
    assert files == _files(out["jax"])
    assert len(files) == 1 + (2 if dataset == "cityscapes" else 7)
    for rel in files:
        _same_file(out["port"] / rel, out["jax"] / rel, rel)


@pytest.fixture(scope="module")
def visualized(tmp_path_factory):
    """Both tools' PNGs of 3 samples of a 4-frame tree at 128x256."""
    root = tmp_path_factory.mktemp("vis")
    write_cityscapes_tree(str(root / "data"), 4, 128, 256, seed=3)
    opts = ["INPUT.MIN_SIZE_TRAIN", "(128,)", "INPUT.MAX_SIZE_TRAIN", "256",
            "INPUT.CROP.SIZE", "(96, 192)"]
    argv = ["--config-file", FINE, "--data-root", str(root / "data"),
            "--num-samples", "3"]
    tdata.DatasetCatalog.clear()
    for name in jcatalog.DatasetCatalog.list():
        jcatalog.DatasetCatalog.remove(name)
    saved = jnative._LIB, jnative._TRIED
    jnative._LIB, jnative._TRIED = None, True
    argv_saved = sys.argv
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            assert visualize_data.main(
                argv + ["--output", str(root / "port"), *opts]) == 0
            sys.argv = ["visualize_data.py", *argv, "--output",
                        str(root / "jax"), *opts]
            _jax_tool("visualize_data").main()
    finally:
        sys.argv = argv_saved
        jnative._LIB, jnative._TRIED = saved
        tdata.DatasetCatalog.clear()
        for name in jcatalog.DatasetCatalog.list():
            jcatalog.DatasetCatalog.remove(name)
    return root, printed.getvalue()


def test_visualize_data_writes_the_jax_tools_files(visualized):
    root, printed = visualized
    files = _files(root / "port")
    assert files == _files(root / "jax")
    assert files == [f"sample{i:03d}_{k}.png" for i in range(3)
                     for k in ("image", "instances", "sem")]
    assert printed.count("written") == 6


@pytest.mark.parametrize("kind", ["image", "sem", "instances"])
def test_visualize_data_pngs_equal_the_jax_tools(visualized, kind):
    root = visualized[0]
    for i in range(3):
        rel = f"sample{i:03d}_{kind}.png"
        _same_file(root / "port" / rel, root / "jax" / rel, rel)
        assert np.asarray(Image.open(root / "port" / rel)).shape[:2] == \
            (96, 192)
