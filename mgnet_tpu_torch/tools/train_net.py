"""Training and evaluation entry point of the port.

    python -m mgnet_tpu_torch.tools.train_net --config-file FILE
        [--eval-only] [--resume] [--data-root DIR] [--device cuda]
        [KEY VALUE ...]

The counterpart of ``tools/train_net.py``: the config (with a timestamped
output subdirectory under ``WRITE_OUTPUT_TO_SUBDIR`` when training, and the
git commit when there is one) is written to ``OUTPUT_DIR/config.yaml``,
the Cityscapes and KITTI-Eigen datasets are registered under
``--data-root`` (default ``$MGNET_DATASETS`` or ``./datasets``), and the
``Trainer`` resumes or loads ``MODEL.WEIGHTS`` and trains on ``--device``.
With ``--eval-only`` the model of the config is built on ``--device``
with ``MODEL.WEIGHTS`` (``load_eval_weights``), ``evaluate_dataset`` runs
over ``DATASETS.TEST[0]``, and the results are printed and appended as
one JSON line to ``OUTPUT_DIR/metrics.json``. The multi-process flags are
not ported.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

import torch

from mgnet_tpu_torch.config import load_config
from mgnet_tpu_torch.data import (
    register_all_cityscapes_scene_seg,
    register_all_kitti_eigen_scene_seg,
)
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.train.trainer import Trainer, evaluate_dataset
from mgnet_tpu_torch.utils.events import MetricLogger
from mgnet_tpu_torch.utils.weights import load_eval_weights

__all__ = ["eval_only", "load_eval_weights", "main", "parse_args",
           "register_datasets", "setup"]


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
    if cfg.WRITE_OUTPUT_TO_SUBDIR and not args.eval_only:
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


def eval_only(cfg, device="cuda") -> Dict[str, Dict[str, float]]:
    """--eval-only: the config's model on ``device`` (weights drawn from
    ``cfg.SEED``, then MODEL.WEIGHTS loaded), evaluated over
    DATASETS.TEST[0]; the results printed and appended to
    ``OUTPUT_DIR/metrics.json``."""
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(cfg.SEED))
    load_eval_weights(model, cfg.MODEL.WEIGHTS)
    model.to(device)
    logger = MetricLogger(cfg.OUTPUT_DIR)
    try:
        results = evaluate_dataset(
            cfg, model, image_logger=logger,
            visualize_dir=(os.path.join(cfg.OUTPUT_DIR, "eval_vis")
                           if cfg.VISUALIZE_EVALUATION else None))
    finally:
        logger.close()
    print(json.dumps(results, indent=2, default=float))
    with open(os.path.join(cfg.OUTPUT_DIR, "metrics.json"), "a") as f:
        f.write(json.dumps(results, default=float) + "\n")
    return results


def main(argv: Optional[List[str]] = None):
    """Train as the command line says and return the finished Trainer;
    with --eval-only, return the evaluation's results."""
    args = parse_args(argv)
    cfg = setup(args)
    register_datasets(args)
    if args.eval_only:
        return eval_only(cfg, device=args.device)
    trainer = Trainer(cfg, device=args.device)
    trainer.resume_or_load(resume=args.resume)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
