"""The port's serving tools against the JAX package's, on the CPU.

* ``data/prepare.py`` against ``datasets/prepare_cityscapes.py`` and
  ``datasets/prepare_kitti_eigen.py`` (run in this process: their pool is
  replaced by a serial map) on the same instanceIds PNGs: equal JSON, and
  panoptic PNGs that decode equal.
* ``tools/generate_pseudo_labels.py``: the port's against the JAX tool's
  ``main``, both in this process from one npz of weights (narrow widths,
  float32, TEST.MSC_FLIP_EVAL False), on a mini tree of four 80x160
  video-sequence frames resized to 64x128, at a batch of two: the same
  file names, each label map equal on >= 99.9% of pixels (the clustering
  near ties of test_torch_fused.py). Then two gloo processes of the port's
  tool: their shards are disjoint and complete, and process 0 alone
  converts.
* ``tools/demo.py`` writes what the ``Predictor`` and ``Visualizer`` give,
  and runs a video through OpenCV (or says that it needs it);
  ``tools/bench.py`` prints the JAX bench's keys and the breakdown rows.
"""

from __future__ import annotations

import importlib.util
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mgnet_tpu.data import catalog as jcatalog
from mgnet_tpu.data import native as jnative

import mgnet_tpu_torch.data as tdata
from mgnet_tpu_torch.config import load_config
from mgnet_tpu_torch.data import prepare
from mgnet_tpu_torch.data.image_io import read_png, write_png
from mgnet_tpu_torch.inference import Predictor
from mgnet_tpu_torch.inference.visualizer import Visualizer
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.parallel import initialize_distributed
from mgnet_tpu_torch.tools import bench, demo, generate_pseudo_labels
from mgnet_tpu_torch.utils.weights import to_jax_arrays

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "datasets"))
import prepare_cityscapes  # noqa: E402
import prepare_kitti_eigen  # noqa: E402

PSEUDO = str(ROOT / "configs" / "MGNet-Cityscapes-PseudoLabelGeneration.yaml")
FINE = str(ROOT / "configs" / "MGNet-Cityscapes-Fine.yaml")
NARROW = ["MODEL.COMPUTE_DTYPE", "float32",
          "MODEL.GCM.GCM_CHANNELS", "32",
          "MODEL.SEM_SEG_HEAD.ARM_CHANNELS", "[32, 32]",
          "MODEL.SEM_SEG_HEAD.REFINE_CHANNELS", "[32, 32]",
          "MODEL.SEM_SEG_HEAD.FFM_CHANNELS", "48",
          "MODEL.SEM_SEG_HEAD.HEAD_CHANNELS", "32",
          "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "128",
          "TEST.MSC_FLIP_EVAL", "False"]
FRAMES, AGREE = 4, 0.999


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads, here and in the processes these tests start:
    the suite runs several files at once, and a full-width bench with a
    thread per core in each of them oversubscribes the cores many times."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(2)
    os.environ["OMP_NUM_THREADS"] = "2"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


class _Serial:
    """Stands in for ``multiprocessing.Pool`` in the JAX converters: the
    same map, in this process."""

    def __init__(self, workers):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, jobs):
        return [fn(j) for j in jobs]


def _instance_ids(rng, h, w):
    """Cityscapes instanceIds: stuff (road 7, building 11, sky 23), two
    cars and a person, a crowd of cars (26, no instance index), void 0
    and an id of no known category (3)."""
    inst = np.full((h, w), 7, np.uint16)
    inst[: h // 3] = 23
    inst[h // 3: h // 2, : w // 4] = 11
    for k, iid in enumerate((26001, 26002, 24001, 26)):
        y, x = rng.integers(h // 3, h - 8), rng.integers(0, w - 12)
        inst[y:y + 8, x:x + 12 + k] = iid
    inst[-3:, :5] = 0
    inst[-3:, -5:] = 3
    return inst


def _write_ids(path, inst, pillow):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if pillow:
        Image.fromarray(inst).save(path)
    else:
        write_png(path, inst)


def _same_conversion(tmp, jax_module, port_kwargs, pngs):
    """Run the JAX converter and the port's on ``tmp/in``; compare."""
    out = {}
    for side in ("jax", "port"):
        png_dir, js = tmp / f"{side}_png", tmp / f"{side}.json"
        if side == "jax":
            jax_module.convert2panoptic(str(tmp / "in"), str(png_dir),
                                        str(js), workers=2)
        else:
            prepare.convert2panoptic(str(tmp / "in"), str(png_dir), str(js),
                                     **port_kwargs)
        out[side] = (png_dir, json.loads(js.read_text()))
    (jdir, want), (pdir, got) = out["jax"], out["port"]
    assert got == want
    assert len(got["annotations"]) == pngs
    for ann in want["annotations"]:
        np.testing.assert_array_equal(
            read_png(pdir / ann["file_name"]),
            np.asarray(Image.open(jdir / ann["file_name"]).convert("RGB")),
            err_msg=ann["file_name"])
    return got


@pytest.mark.parametrize("workers", [0, 2])
def test_cityscapes_conversion_matches_jax(tmp_path, monkeypatch, workers):
    monkeypatch.setattr(prepare_cityscapes, "Pool", _Serial)
    rng = np.random.default_rng(1)
    for i, pillow in enumerate((True, False, True)):
        _write_ids(str(tmp_path / "in" / "c" /
                       f"c_000000_{i:06d}_instanceIds.png"),
                   _instance_ids(rng, 40, 64), pillow)
    got = _same_conversion(tmp_path, prepare_cityscapes,
                           {"workers": workers}, 3)
    segs = got["annotations"][0]["segments_info"]
    assert {s["id"] for s in segs} == {7, 11, 23, 24001, 26001, 26002, 26}
    assert [s["iscrowd"] for s in segs if s["id"] == 26] == [1]


def test_kitti_conversion_keeps_the_drive_tree(tmp_path, monkeypatch):
    monkeypatch.setattr(prepare_kitti_eigen, "Pool", _Serial)
    rng = np.random.default_rng(2)
    for drive in ("2011_09_26_drive_0001_sync", "2011_09_26_drive_0002_sync"):
        _write_ids(str(tmp_path / "in" / "2011_09_26" / drive / "label_02"
                       / "data" / "0000000005_instanceIds.png"),
                   _instance_ids(rng, 24, 80), False)
    got = _same_conversion(tmp_path, prepare_kitti_eigen,
                           {"workers": 0, "kitti": True}, 2)
    assert got["annotations"][0]["file_name"] == (
        "2011_09_26/2011_09_26_drive_0001_sync/label_02/data/0000000005.png")


def test_conversion_without_labels_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="instanceIds"):
        prepare.convert2panoptic(str(tmp_path), str(tmp_path / "o"),
                                 str(tmp_path / "o.json"), workers=0)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A mini tree of FRAMES 80x160 sequence frames, one npz of narrow
    weights for both packages (seeded draw, JAX layout), one curated
    label, a camera JSON."""
    root = tmp_path_factory.mktemp("pseudo")
    tdata.write_cityscapes_tree(str(root), FRAMES, 80, 160, seed=4)
    cfg = load_config(FINE, NARROW)
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(5))
    np.savez(root / "narrow.npz", **to_jax_arrays(model.state_dict()))
    gt = root / "gt" / "synth"
    gt.mkdir(parents=True)
    curated = _instance_ids(np.random.default_rng(3), 64, 128)
    write_png(gt / "synth_000000_000029_instanceIds.png", curated)
    return root


def _pseudo_argv(root, out, *extra):
    """The tool's flags (a later --config-file wins) and NARROW."""
    return ["--config-file", PSEUDO, "--data-root", str(root), "--weights",
            str(root / "narrow.npz"), "--output", str(out), "--batch", "2",
            *extra, *NARROW]


def _load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_pseudo_labels", ROOT / "tools" /
        "generate_pseudo_labels.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _clear_catalogs():
    for name in list(jcatalog.DatasetCatalog.list()):
        jcatalog.DatasetCatalog.remove(name)
    jcatalog.MetadataCatalog.clear()
    tdata.DatasetCatalog.clear()
    tdata.MetadataCatalog.clear()


KITTI_DRIVES = ("2011_09_26/2011_09_26_drive_0001_sync",
                "2011_09_26/2011_09_26_drive_0002_sync")


@pytest.fixture(scope="module")
def kitti_tree(tree, tmp_path_factory):
    """Two KITTI drives of 96x320 frames 4-6 whose frame 5 is in the Zhou
    split (the same frame number in both drives), their calibration, and
    the npz of ``tree``."""
    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(8)
    rels = []
    for drive in KITTI_DRIVES:
        img_dir = root / "kitti_eigen" / drive / "image_02" / "data"
        img_dir.mkdir(parents=True)
        for i in (4, 5, 6):
            write_png(img_dir / f"{i:010d}.png",
                      rng.integers(0, 256, (96, 320, 3), np.uint8))
        rels.append(f"{drive}/image_02/data/{5:010d}.png l\n")
    (root / "kitti_eigen" / "2011_09_26" / "calib_cam_to_cam.txt"
     ).write_text("calib_time: 2011\nP_rect_02: 250.0 0.0 160.0 0.0 0.0 "
                  "250.0 48.0 0.0 0.0 0.0 1.0 0.0\n")
    splits = root / "kitti_eigen" / "data_splits"
    splits.mkdir()
    (splits / "eigen_zhou_files.txt").write_text("".join(rels))
    (root / "narrow.npz").symlink_to(tree / "narrow.npz")
    return root


def _label_files(out):
    return sorted(str(p.relative_to(out)) for p in out.rglob("*.png"))


@pytest.mark.parametrize("layout", ["cityscapes", "kitti"])
def test_pseudo_labels_match_the_jax_tool(layout, request, tmp_path,
                                          monkeypatch, capsys):
    """Both tools on one tree and one npz (the JAX one with its native
    image library off, so that it never builds native/build/): the same
    label files (KITTI's in the drive tree), uint16, equal on >= 99.9% of
    pixels; the curated Cityscapes label copied over; the port's
    --convert-json equal to the JAX converter on the same labels."""
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    if layout == "kitti":
        root = request.getfixturevalue("kitti_tree")
        extra = ["--config-file", str(ROOT / "configs" /
                                      "MGNet-KITTI-Eigen-PseudoLabelGeneration"
                                      ".yaml"),
                 "--dataset", "kitti_zhou_scene_seg_train"]
        # resized to 38x128; the frame's outputs come at multiples of its
        # stride of 8
        n, shape, converter = 2, (40, 128), prepare_kitti_eigen
    else:
        root = request.getfixturevalue("tree")
        extra = ["--gt-instance-dir", str(root / "gt")]
        n, shape, converter = FRAMES, (64, 128), prepare_cityscapes
    _clear_catalogs()
    try:
        monkeypatch.setattr(sys, "argv", ["generate_pseudo_labels.py",
                                          *_pseudo_argv(root, jax_out,
                                                        *extra)])
        _load_jax_tool().main()
        generate_pseudo_labels.main(_pseudo_argv(
            root, port_out, *extra, "--device", "cpu", "--convert-json",
            str(tmp_path / "port.json")))
    finally:
        _clear_catalogs()
    printed = capsys.readouterr().out
    assert printed.count(f"Wrote pseudo labels for {n} images") == 2
    assert "89,250-frame video-sequence split" in printed
    names = _label_files(jax_out)
    assert _label_files(port_out) == names and len(names) == n
    if layout == "kitti":
        assert names == [f"{d}/label_02/data/0000000005_instanceIds.png"
                         for d in KITTI_DRIVES]
    for name in names:
        got = read_png(port_out / name)
        want = np.asarray(Image.open(jax_out / name))
        assert got.dtype == np.uint16 and got.shape == want.shape == shape
        assert (got == want).mean() >= AGREE, name
    if layout == "cityscapes":
        np.testing.assert_array_equal(
            read_png(port_out / "synth_000000_000029_instanceIds.png"),
            read_png(root / "gt" / "synth" /
                     "synth_000000_000029_instanceIds.png"))
    monkeypatch.setattr(converter, "Pool", _Serial)
    converter.convert2panoptic(str(port_out), str(tmp_path / "j"),
                               str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())


def test_pseudo_labels_in_two_processes(tree, tmp_path):
    """--num-processes 2 over gloo: the shards are disjoint and together
    complete, and process 0 alone copies and converts."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = tmp_path / "labels"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mgnet_tpu_torch.tools.generate_pseudo_labels",
         *_pseudo_argv(tree, out, "--gt-instance-dir", str(tree / "gt"),
                       "--device", "cpu", "--num-processes", "2",
                       "--process-id", str(rank), "--coordinator",
                       f"127.0.0.1:{port}", "--convert-json",
                       str(tmp_path / "pan.json"))],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in (0, 1)]
    results = [p.communicate(timeout=300) for p in procs]
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, stderr[-3000:]
    counts = [int(o.split("Wrote pseudo labels for ")[1].split()[0])
              for o, _ in results]
    assert counts == [FRAMES // 2, FRAMES // 2]
    assert len(os.listdir(out)) == FRAMES
    assert "Converted" in results[0][0] and "Converted" not in results[1][0]
    assert "Copied" not in results[1][0]
    ann = json.loads((tmp_path / "pan.json").read_text())["annotations"]
    assert len(ann) == FRAMES


def test_initialize_distributed_is_a_no_op_for_one_process():
    initialize_distributed("127.0.0.1:1", 1, 0)
    initialize_distributed()
    assert not torch.distributed.is_initialized()


def _demo_argv(tree, out, *extra):
    # extra first: --input takes every argument up to the next flag
    return [*extra, "--config-file", FINE, "--output", str(out), "--device",
            "cpu", "--weights", str(tree / "narrow.npz"), *NARROW]


def test_demo_writes_the_predictor_and_visualizer_outputs(tree, tmp_path):
    seq = tree / "cityscapes" / "leftImg8bit_sequence" / "train" / "synth"
    inputs = [seq / "synth_000000_000019_leftImg8bit.png",
              seq / "synth_000000_000030_leftImg8bit.png"]
    calib = tree / "cityscapes" / "camera" / "train" / "synth" / \
        "synth_000000_000019_camera.json"
    demo.main(_demo_argv(tree, tmp_path, "--calib", str(calib),
                         "--save-pcl", "--input", *map(str, inputs)))
    cfg = load_config(FINE, [*NARROW, "MODEL.WEIGHTS",
                             str(tree / "narrow.npz")])
    tdata.MetadataCatalog.clear()
    pred = Predictor(cfg, calibration_info=json.loads(calib.read_text()),
                     dataset_name="demo", device="cpu")
    vis = Visualizer(pred.metadata)
    for path in inputs:
        img = read_png(path)
        out = pred(img)
        stem = tmp_path / path.stem
        want = {"panoptic": vis.panoptic_rgb(out["panoptic"], img),
                "instances": vis.instance_heatmap_rgb(out["center"],
                                                      out["offset"]),
                "depth": vis.depth_rgb(out["depth"])}
        for k, v in want.items():
            assert v.shape == (64, 128, 3)
            np.testing.assert_array_equal(read_png(f"{stem}_{k}.png"), v,
                                          err_msg=k)
        np.testing.assert_array_equal(np.load(f"{stem}_points.npy"),
                                      out["points"])


def test_demo_runs_a_video(tree, tmp_path):
    cv2 = pytest.importorskip("cv2")
    clip = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (160, 80))
    rng = np.random.default_rng(6)
    for _ in range(3):
        writer.write(rng.integers(0, 256, (80, 160, 3), np.uint8))
    writer.release()
    demo.main(_demo_argv(tree, tmp_path, "--video-input", clip))
    cap = cv2.VideoCapture(str(tmp_path / "demo_output.mp4"))
    shapes = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        shapes.append(frame.shape)
    cap.release()
    assert shapes == [(128, 128, 3)] * 3  # the overlay above the depth


def test_demo_video_names_opencv_when_it_is_missing(tree, tmp_path,
                                                    monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        demo.main(_demo_argv(tree, tmp_path, "--video-input", "clip.mp4"))


def test_bench_prints_the_jax_keys_and_the_breakdown(capsys):
    rec = bench.main(["--device", "cpu", "--height", "32", "--width", "64",
                      "--breakdown"])
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == rec
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == "joint_panoptic_depth_inference_fps_32x64"
    assert rec["unit"] == "fps" and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 30.0, 4)
    lines = err.splitlines()
    assert lines[0] == "# device: cpu (no card)"
    assert [line.split(":")[0] for line in lines[1:]] == [
        "# model_forward", "# panoptic_fusion_kernel",
        "# panoptic_fusion_plain", "# dgc_scaling", "# full_fused"]


def test_bench_repeat_reports_mean_and_spread(capsys):
    rec = bench.main(["--device", "cpu", "--height", "32", "--width", "64",
                      "--repeat", "2"])
    out, err = capsys.readouterr()
    assert list(rec) == ["metric", "value", "unit", "vs_baseline", "std",
                         "runs"]
    assert len(rec["runs"]) == 2
    assert rec["value"] == pytest.approx(np.mean(rec["runs"]), abs=1e-3)
    assert rec["std"] == pytest.approx(np.std(rec["runs"], ddof=1), abs=1e-3)
    assert err.count("# device: cpu (no card)") == 2
    assert "fps over 2 runs" in err


@pytest.mark.parametrize("tool", [demo, generate_pseudo_labels, bench])
def test_tools_default_to_the_card(tool):
    argv = {demo: ["--config-file", FINE, "--output", "o"],
            generate_pseudo_labels: ["--config-file", PSEUDO, "--output",
                                     "o"],
            bench: []}[tool]
    assert tool.parse_args(argv).device == "cuda"
