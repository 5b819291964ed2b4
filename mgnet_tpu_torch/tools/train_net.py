"""Training entry point of the port.

    python -m mgnet_tpu_torch.tools.train_net --config-file FILE
        [--resume] [--data-root DIR] [--device cuda] [KEY VALUE ...]

The counterpart of ``tools/train_net.py`` for training: the config (with a
timestamped output subdirectory under ``WRITE_OUTPUT_TO_SUBDIR`` and the
git commit when there is one) is written to ``OUTPUT_DIR/config.yaml``,
the Cityscapes and KITTI-Eigen datasets are registered under
``--data-root`` (default ``$MGNET_DATASETS`` or ``./datasets``), and the
``Trainer`` resumes or loads ``MODEL.WEIGHTS`` and trains on ``--device``.
``--eval-only`` raises until the evaluation slice; the multi-process flags
are not ported.
"""

from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
from typing import List, Optional

from mgnet_tpu_torch.config import load_config
from mgnet_tpu_torch.data import (
    register_all_cityscapes_scene_seg,
    register_all_kitti_eigen_scene_seg,
)
from mgnet_tpu_torch.train.trainer import EVAL_NOT_PORTED, Trainer

__all__ = ["main", "parse_args", "register_datasets", "setup"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--data-root", default="")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def setup(args):
    cfg = load_config(args.config_file or None, args.opts)
    if cfg.WRITE_OUTPUT_TO_SUBDIR:
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        name = os.path.splitext(os.path.basename(args.config_file or "run"))[0]
        cfg.OUTPUT_DIR = os.path.join(cfg.OUTPUT_DIR, f"{stamp}_{name}")
    try:
        cfg.COMMIT_ID = subprocess.check_output(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.DEVNULL,
        ).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        pass  # not a git checkout
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    return cfg


def register_datasets(args):
    root = args.data_root or os.environ.get("MGNET_DATASETS", "./datasets")
    for register in (register_all_cityscapes_scene_seg,
                     register_all_kitti_eigen_scene_seg):
        try:
            register(root)
        except KeyError:
            pass  # registered already in this process


def main(argv: Optional[List[str]] = None) -> Trainer:
    """Train as the command line says; returns the finished Trainer."""
    args = parse_args(argv)
    if args.eval_only:
        raise NotImplementedError("--eval-only: " + EVAL_NOT_PORTED)
    cfg = setup(args)
    register_datasets(args)
    trainer = Trainer(cfg, device=args.device)
    trainer.resume_or_load(resume=args.resume)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
