"""One-command runbook of the port: prepare -> init -> train -> eval
(and, with ``--stages all``, -> pseudo labels -> video sequence -> KITTI).

    python -m mgnet_tpu_torch.tools.run_pipeline --data-root /datasets
        --backbone-pth swsl_resnet18.pth --pose-pth resnet18.pth
        [--stages prepare,init,train,eval | all] [--resume] [--force]
        [--device cuda]
    python -m mgnet_tpu_torch.tools.run_pipeline --smoke [--device cpu]
    python -m mgnet_tpu_torch.tools.run_pipeline --drill --stages all

The counterpart of ``tools/run_pipeline.py``, with its stages, flags and
smoke settings. Each stage runs a tool of the port in a subprocess
(``python -m mgnet_tpu_torch.tools.<tool>``, from the repository's root)
and passes ``--device`` to those that run a model:

* prepare: ``tools.prepare_cityscapes`` on each split's instanceIds PNGs
  (COCO-panoptic PNGs and JSON);
* init: ``tools.convert_torchvision_weights``, the user's torchvision or
  SWSL ResNet-18 ``.pth`` files into ``WEIGHTS_DIR/imagenet_weights.npz``
  (with ``--smoke``, a seeded torchvision-shaped ``.pth`` first);
  nothing is downloaded;
* train and eval: ``tools.train_net`` (``--eval-only`` for eval) on
  ``--config``, writing ``OUTPUT_DIR/model_final`` and
  ``OUTPUT_DIR/metrics.json``;
* pseudo: ``tools.generate_pseudo_labels`` on the Cityscapes
  video-sequence split (curated fine labels copied over), then
  ``tools.prepare_cityscapes`` into ``gtFine_sequence``;
* video: ``tools.train_net`` on the VideoSequence config from
  ``model_final``;
* kitti: pseudo labels on KITTI Eigen-Zhou, ``tools.prepare_kitti_eigen``,
  the Eigen-Zhou training and its depth evaluation.

``--smoke`` writes raw mini trees (``data.make_synthetic_cityscapes_raw``,
128x256, and with kitti ``make_synthetic_kitti_raw``, 96x320) into a
temporary ``--data-root``, fabricates the weights and trains 3 iterations
at tiny sizes; ``--drill`` writes the trees at 1024x2048 and 384x1280 and
runs the configs' own input pipeline on the same tiny schedule (a run for
the card). Both train as one process (``--num-devices 1``, as
``MESH.DATA 1`` asks). Each stage's seconds are printed, and last
``PIPELINE OK: stage[seconds] -> ...``.

This module imports only the standard library; the stages import the
port.
"""

import argparse
import glob
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))

SMOKE_TRAIN_OPTS = [
    "MODEL.COMPUTE_DTYPE", "float32",
    "MODEL.SEM_SEG_HEAD.OHEM_N_MIN", "256",
    "INPUT.MIN_SIZE_TRAIN", "(128,)",
    "INPUT.MAX_SIZE_TRAIN", "256",
    "INPUT.CROP.SIZE", "(64, 64)",
    "INPUT.MIN_SIZE_TEST", "128",
    "INPUT.MAX_SIZE_TEST", "256",
]

# KITTI smoke tree is 96x320 (data/synthetic.py)
SMOKE_KITTI_OPTS = [
    "MODEL.COMPUTE_DTYPE", "float32",
    "MODEL.SEM_SEG_HEAD.OHEM_N_MIN", "256",
    "INPUT.MIN_SIZE_TRAIN", "(96,)",
    "INPUT.MAX_SIZE_TRAIN", "320",
    "INPUT.CROP.ENABLED", "False",
    "INPUT.MIN_SIZE_TEST", "96",
    "INPUT.MAX_SIZE_TEST", "320",
]

TINY_RUN_OPTS = [
    "SOLVER.MAX_ITER", "3",
    "SOLVER.IMS_PER_BATCH", "2",
    "SOLVER.CHECKPOINT_PERIOD", "3",
    "SOLVER.WARMUP_ITERS", "2",
    "TEST.EVAL_PERIOD", "0",
    "DATALOADER.NUM_WORKERS", "2",
    "MESH.DATA", "1",
    "WRITE_OUTPUT_TO_SUBDIR", "False",
]


def sh(cmd, **kw):
    print(f"+ {' '.join(cmd)}", flush=True)
    subprocess.run(cmd, check=True, cwd=REPO, **kw)


def tool(name: str) -> list:
    """The command line of the port's tool ``name``."""
    return [sys.executable, "-m", f"mgnet_tpu_torch.tools.{name}"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_flags(args) -> list:
    """train_net's flags: the device, and with the tiny schedule's
    ``MESH.DATA 1`` one process, whatever the cards."""
    flags = ["--device", args.device]
    if args.smoke:
        flags += ["--num-devices", "1", "--coordinator",
                  f"127.0.0.1:{_free_port()}"]
    return flags


def stage_prepare(args):
    """instanceIds PNGs -> COCO-panoptic PNGs + json (both splits)."""
    for split in ("train", "val"):
        in_dir = os.path.join(args.data_root, "cityscapes", "gtFine", split)
        out_dir = os.path.join(
            args.data_root, "cityscapes", "gtFine",
            f"cityscapes_panoptic_{split}")
        json_path = out_dir + ".json"
        if not glob.glob(os.path.join(in_dir, "*", "*_instanceIds.png")):
            print(f"prepare: no instanceIds under {in_dir}, skipping")
            continue
        if os.path.exists(json_path) and not args.force:
            print(f"prepare: {json_path} exists, skipping")
            continue
        sh(tool("prepare_cityscapes") + [
            "--input-dir", in_dir, "--output-dir", out_dir,
            "--json", json_path, "--workers", str(args.workers)])


def stage_init(args):
    """torchvision ResNet-18 .pth -> WEIGHTS_DIR/imagenet_weights.npz."""
    out = os.path.join(args.weights_dir, "imagenet_weights.npz")
    if os.path.exists(out) and not args.force:
        print(f"init: {out} exists, skipping")
        return out
    backbone = args.backbone_pth
    pose = args.pose_pth or backbone
    if args.smoke:
        backbone = pose = _fabricate_torchvision_pth(args.weights_dir)
    if not backbone:
        raise SystemExit(
            "init: pass --backbone-pth (a torchvision or SWSL ResNet-18 "
            ".pth that you supply: semi_weakly_supervised_resnet18 for the "
            "backbone, torchvision's resnet18 for --pose-pth)")
    cmd = tool("convert_torchvision_weights") + [
        "--backbone", backbone, "--output", out]
    if pose:
        cmd += ["--pose", pose]
    sh(cmd)
    return out


def _fabricate_torchvision_pth(weights_dir: str) -> str:
    """Random torchvision-R18-shaped state dict for smoke runs."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)

    def conv(o, i, k):
        return torch.from_numpy(
            rng.randn(o, i, k, k).astype("float32") * 0.05)

    sd = {"conv1.weight": conv(64, 3, 7)}
    for s in ("weight", "bias", "running_mean", "running_var"):
        sd[f"bn1.{s}"] = torch.from_numpy(rng.rand(64).astype("float32"))
    chans = [64, 64, 128, 256, 512]
    for st in range(4):
        for b in range(2):
            cin = chans[st] if b == 0 else chans[st + 1]
            cout = chans[st + 1]
            p = f"layer{st + 1}.{b}"
            sd[f"{p}.conv1.weight"] = conv(cout, cin, 3)
            sd[f"{p}.conv2.weight"] = conv(cout, cout, 3)
            for bn in ("bn1", "bn2"):
                for s in ("weight", "bias", "running_mean",
                          "running_var"):
                    sd[f"{p}.{bn}.{s}"] = torch.from_numpy(
                        rng.rand(cout).astype("float32"))
            if cin != cout:
                sd[f"{p}.downsample.0.weight"] = conv(cout, cin, 1)
                for s in ("weight", "bias", "running_mean",
                          "running_var"):
                    sd[f"{p}.downsample.1.{s}"] = torch.from_numpy(
                        rng.rand(cout).astype("float32"))
    os.makedirs(weights_dir, exist_ok=True)
    path = os.path.join(weights_dir, "smoke_resnet18.pth")
    torch.save(sd, path)
    return path


def _train_opts(args, kitti=False):
    """Config overrides for synthetic runs. --smoke shrinks input sizes
    AND the schedule; --drill keeps the configs' full-resolution input
    pipeline (1024x1024 crops of 1024x2048 frames on Cityscapes) and
    shrinks only the schedule, so that every shape, mapper path and eval
    bucket is a real-data run's."""
    if args.drill:
        return list(TINY_RUN_OPTS)
    if args.smoke:
        return (SMOKE_KITTI_OPTS if kitti else SMOKE_TRAIN_OPTS) + \
            TINY_RUN_OPTS
    return []


def stage_train(args, weights_npz):
    cmd = tool("train_net") + _train_flags(args) + [
        "--config-file", args.config,
        "--data-root", args.data_root,
        "MODEL.WEIGHTS", weights_npz or "",
        "OUTPUT_DIR", args.output_dir]
    cmd += _train_opts(args)
    if args.resume:
        cmd.insert(3, "--resume")
    sh(cmd)
    final = os.path.join(args.output_dir, "model_final")
    if not os.path.exists(final):
        raise SystemExit(f"training left no {final}")
    return final


def stage_eval(args, model_final):
    cmd = tool("train_net") + _train_flags(args) + [
        "--eval-only",
        "--config-file", args.config,
        "--data-root", args.data_root,
        "MODEL.WEIGHTS", model_final,
        "OUTPUT_DIR", args.output_dir]
    cmd += _train_opts(args)
    sh(cmd)
    metrics = os.path.join(args.output_dir, "metrics.json")
    if not os.path.exists(metrics):
        raise SystemExit("eval wrote no metrics.json")
    with open(metrics) as f:
        last = json.loads(f.read().strip().splitlines()[-1])
    print("eval results:", json.dumps(last, indent=2, default=float))


def stage_pseudo(args, model_final):
    """Cityscapes video-sequence pseudo labels with the fine-trained model
    (MSC-flip per the PseudoLabelGeneration config), then their
    conversion into gtFine_sequence, after which
    cityscapes_scene_seg_train_video_sequence is trainable."""
    seq_root = os.path.join(args.data_root, "cityscapes", "gtFine_sequence")
    inst_dir = os.path.join(seq_root, "pseudo_instanceIds")
    cmd = tool("generate_pseudo_labels") + [
        "--config-file",
        "configs/MGNet-Cityscapes-PseudoLabelGeneration.yaml",
        "--dataset", "cityscapes_scene_seg_train_video_sequence",
        "--data-root", args.data_root,
        "--weights", model_final,
        "--output", inst_dir,
        "--batch", "2",
        "--device", args.device,
        # curated fine labels override pseudo labels where they exist
        "--gt-instance-dir",
        os.path.join(args.data_root, "cityscapes", "gtFine", "train")]
    if args.smoke:
        cmd += ["INPUT.MIN_SIZE_TEST", "128", "INPUT.MAX_SIZE_TEST", "256",
                "MODEL.COMPUTE_DTYPE", "float32"]
    sh(cmd)
    sh(tool("prepare_cityscapes") + [
        "--input-dir", inst_dir,
        "--output-dir", os.path.join(seq_root, "cityscapes_panoptic_train"),
        "--json", os.path.join(seq_root, "cityscapes_panoptic_train.json"),
        "--workers", str(args.workers)])


def stage_video(args, model_final, weights_npz):
    """Retrain on the pseudo-labeled video-sequence split, initialized
    from the fine-trained checkpoint."""
    out = args.output_dir.rstrip("/") + "_video"
    cmd = tool("train_net") + _train_flags(args) + [
        "--config-file", "configs/MGNet-Cityscapes-VideoSequence.yaml",
        "--data-root", args.data_root,
        "MODEL.WEIGHTS", model_final or weights_npz or "",
        "OUTPUT_DIR", out]
    cmd += _train_opts(args)
    sh(cmd)
    final = os.path.join(out, "model_final")
    if not os.path.exists(final):
        raise SystemExit(f"video training left no {final}")
    return final


def stage_kitti(args, model_final, weights_npz):
    """KITTI leg: pseudo labels on the Eigen-Zhou split with the fine
    model, their conversion, the Eigen-Zhou training (fine init) and its
    depth evaluation."""
    plabel_root = os.path.join(args.data_root, "kitti_eigen",
                               "panoptic_pseudo_labels")
    inst_dir = os.path.join(plabel_root, "pseudo_instanceIds")
    cmd = tool("generate_pseudo_labels") + [
        "--config-file",
        "configs/MGNet-KITTI-Eigen-PseudoLabelGeneration.yaml",
        "--dataset", "kitti_zhou_scene_seg_train",
        "--data-root", args.data_root,
        "--weights", model_final,
        "--output", inst_dir,
        "--batch", "2",
        "--device", args.device]
    if args.smoke:
        cmd += ["INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "320",
                "MODEL.COMPUTE_DTYPE", "float32"]
    sh(cmd)
    sh(tool("prepare_kitti_eigen") + [
        "--input-dir", inst_dir,
        "--output-dir", os.path.join(plabel_root,
                                     "eigen_zhou_files_panoptic"),
        "--json", os.path.join(plabel_root,
                               "eigen_zhou_files_panoptic.json"),
        "--workers", str(args.workers)])

    out = args.output_dir.rstrip("/") + "_kitti"
    base = tool("train_net") + _train_flags(args) + [
        "--config-file", "configs/MGNet-KITTI-Eigen-Zhou.yaml",
        "--data-root", args.data_root]
    sh(base + ["MODEL.WEIGHTS", model_final or weights_npz or "",
               "OUTPUT_DIR", out] + _train_opts(args, kitti=True))
    final = os.path.join(out, "model_final")
    if not os.path.exists(final):
        raise SystemExit(f"KITTI training left no {final}")
    sh(base + ["--eval-only", "MODEL.WEIGHTS", final, "OUTPUT_DIR", out]
       + _train_opts(args, kitti=True))
    if not os.path.exists(os.path.join(out, "metrics.json")):
        raise SystemExit("KITTI eval wrote no metrics.json")
    return final


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-root", default="./datasets")
    p.add_argument("--weights-dir", default="",
                   help="where init writes imagenet_weights.npz (default "
                        "./weights; with --smoke a temporary directory, "
                        "so that the fabricated weights never replace "
                        "the checkout's)")
    p.add_argument("--backbone-pth", default="",
                   help="torchvision/SWSL ResNet-18 checkpoint")
    p.add_argument("--pose-pth", default="",
                   help="vanilla ResNet-18 checkpoint for the pose net")
    p.add_argument("--config",
                   default="configs/MGNet-Cityscapes-Fine.yaml")
    p.add_argument("--output-dir", default="")
    p.add_argument("--stages", default="prepare,init,train,eval",
                   help="comma list from: prepare,init,train,eval,pseudo,"
                        "video,kitti; or 'all' for the full 3-config "
                        "chain (Fine -> pseudo labels -> VideoSequence -> "
                        "KITTI Eigen-Zhou)")
    p.add_argument("--workers", type=int, default=8,
                   help="processes of the prepare conversions (0: the "
                        "tool's own process)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="synthesize mini data + weights; tiny train/eval")
    p.add_argument("--drill", action="store_true",
                   help="full-size drill: synthesize 1024x2048 Cityscapes "
                        "and 384x1280 KITTI trees and run the chain with "
                        "the configs' own input pipeline on the tiny "
                        "schedule (for the card)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit(f"run_pipeline: --device {args.device} but no "
                             "CUDA card is visible (--device cpu runs on "
                             "the host)")
    if args.drill:
        args.smoke = True  # the drill is synthetic data, tiny schedule
    if args.smoke and args.data_root == "./datasets":
        args.data_root = tempfile.mkdtemp(prefix="mgnet_smoke_data_")
    if args.smoke and not args.output_dir:
        args.output_dir = tempfile.mkdtemp(prefix="mgnet_smoke_out_")
    if not args.weights_dir:
        args.weights_dir = (tempfile.mkdtemp(prefix="mgnet_smoke_weights_")
                            if args.smoke else "./weights")
    if not args.output_dir:
        args.output_dir = "./output/pipeline"
    args.data_root, args.output_dir, args.weights_dir = (
        os.path.abspath(p) for p in (args.data_root, args.output_dir,
                                     args.weights_dir))
    if args.stages.strip() == "all":
        args.stages = "prepare,init,train,eval,pseudo,video,kitti"
    stages = [s.strip() for s in args.stages.split(",") if s.strip()]

    if args.smoke:
        sys.path.insert(0, REPO)
        from mgnet_tpu_torch.data import (
            make_synthetic_cityscapes_raw,
            make_synthetic_kitti_raw,
        )

        cs_shape = (1024, 2048) if args.drill else (128, 256)
        for split in ("train", "val"):
            make_synthetic_cityscapes_raw(
                args.data_root, split, height=cs_shape[0], width=cs_shape[1])
        if "kitti" in stages:
            kt_shape = (384, 1280) if args.drill else (96, 320)
            make_synthetic_kitti_raw(
                args.data_root, height=kt_shape[0], width=kt_shape[1])
        print(f"smoke: synthetic raw dataset at {args.data_root} "
              f"({cs_shape[0]}x{cs_shape[1]})")

    weights_npz = os.path.join(args.weights_dir, "imagenet_weights.npz")
    model_final = os.path.join(args.output_dir, "model_final")
    elapsed = {}

    def timed(name, fn):
        t0 = time.monotonic()
        out = fn()
        elapsed[name] = time.monotonic() - t0
        print(f"stage {name}: {elapsed[name]:.1f} s", flush=True)
        return out

    if "prepare" in stages:
        timed("prepare", lambda: stage_prepare(args))
    if "init" in stages:
        weights_npz = timed("init", lambda: stage_init(args))
    if "train" in stages:
        model_final = timed("train", lambda: stage_train(
            args, weights_npz if os.path.exists(weights_npz) else ""))
    if "eval" in stages:
        timed("eval", lambda: stage_eval(args, model_final))
    if "pseudo" in stages:
        timed("pseudo", lambda: stage_pseudo(args, model_final))
    if "video" in stages:
        timed("video", lambda: stage_video(args, model_final, weights_npz))
    if "kitti" in stages:
        timed("kitti", lambda: stage_kitti(args, model_final, weights_npz))
    print("PIPELINE OK:", " -> ".join(
        f"{s}[{elapsed.get(s, 0):.0f}s]" for s in stages), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
