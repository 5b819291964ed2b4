"""Training and evaluation entry point of the port.

    python -m mgnet_tpu_torch.tools.train_net --config-file FILE
        [--eval-only] [--resume] [--data-root DIR] [--device cuda]
        [--num-devices N] [--num-processes HOSTS --process-id I
         --coordinator HOST:PORT] [KEY VALUE ...]

The counterpart of ``tools/train_net.py``: the config (with a timestamped
output subdirectory under ``WRITE_OUTPUT_TO_SUBDIR`` when training, and the
git commit when there is one) is written to ``OUTPUT_DIR/config.yaml``,
the Cityscapes and KITTI-Eigen datasets are registered under
``--data-root`` (default ``$MGNET_DATASETS`` or ``./datasets``), and the
``Trainer`` resumes or loads ``MODEL.WEIGHTS`` and trains on ``--device``.
With ``--eval-only`` the model of the config is built on ``--device``
with ``MODEL.WEIGHTS`` (``load_eval_weights``), ``evaluate_dataset`` runs
over ``DATASETS.TEST[0]``, and the results are printed and appended as
one JSON line to ``OUTPUT_DIR/metrics.json``.

Several cards, with the JAX command's flags and meanings: ``--num-devices
N`` runs N ranks on this host, one process and one card each (-1, the
default: every visible card; one process with ``--device cpu``), and sets
``MESH.DATA`` to the world size over ``MESH.MODEL`` (the ranks of one
data shard, which hold copies of it: ``parallel.multihost``);
``--num-processes`` is the number of hosts, ``--process-id`` this host's
index and ``--coordinator`` the ``host:port`` of host 0, where the
group's store listens. A rank's global
index is ``process_id * N + local rank`` of a world of ``num_processes *
N``. The ranks are started by ``torch.multiprocessing`` spawn, over NCCL
on the cards and gloo with ``--device cpu``; a rank that fails makes the
command fail. A world of one runs in the command's own process: as one
rank of a group when ``--num-devices`` or ``--num-processes`` is given,
and without any group otherwise. Only rank 0 writes the config, the
checkpoints, ``model_final`` and the metrics.
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
from mgnet_tpu_torch.parallel import (
    broadcast_object,
    initialize_distributed,
    is_main_process,
    shutdown_distributed,
)
from mgnet_tpu_torch.train.trainer import Trainer, evaluate_dataset
from mgnet_tpu_torch.utils.events import MetricLogger
from mgnet_tpu_torch.utils.weights import load_eval_weights

__all__ = ["eval_only", "load_eval_weights", "local_ranks", "main",
           "parse_args", "register_datasets", "run", "run_rank", "setup"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--data-root", default="")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--num-devices", type=int, default=-1,
                        help="ranks on this host, one card each (-1 = "
                             "every visible card; one with --device cpu)")
    parser.add_argument("--num-processes", type=int, default=1,
                        help="hosts, each running this command")
    parser.add_argument("--process-id", type=int, default=0,
                        help="this host's index")
    parser.add_argument("--coordinator", default="127.0.0.1:12355",
                        help="host:port of host 0 for several processes")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def local_ranks(args) -> int:
    """Ranks on this host: ``--num-devices``, or every visible card (one
    process on the CPU)."""
    if args.num_devices > 0:
        return args.num_devices
    if torch.device(args.device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def setup(args):
    cfg = load_config(args.config_file or None, args.opts)
    if getattr(args, "num_devices", -1) != -1:
        world = args.num_processes * args.num_devices
        if world % int(cfg.MESH.MODEL):
            raise ValueError(f"{world} ranks do not divide over "
                             f"MESH.MODEL={cfg.MESH.MODEL}")
        cfg.MESH.DATA = world // int(cfg.MESH.MODEL)
    if cfg.WRITE_OUTPUT_TO_SUBDIR and not args.eval_only:
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        name = os.path.splitext(os.path.basename(args.config_file or "run"))[0]
        # rank 0's stamp on every rank
        cfg.OUTPUT_DIR = broadcast_object(
            os.path.join(cfg.OUTPUT_DIR, f"{stamp}_{name}"))
    try:
        cfg.COMMIT_ID = subprocess.check_output(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.DEVNULL,
        ).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        pass  # not a git checkout
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    if is_main_process():
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
    if is_main_process():
        print(json.dumps(results, indent=2, default=float))
        with open(os.path.join(cfg.OUTPUT_DIR, "metrics.json"), "a") as f:
            f.write(json.dumps(results, default=float) + "\n")
    return results


def run(args, device):
    """The command on ``device``: the finished Trainer, or with
    --eval-only the evaluation's results."""
    cfg = setup(args)
    register_datasets(args)
    if args.eval_only:
        return eval_only(cfg, device=device)
    trainer = Trainer(cfg, device=device)
    trainer.resume_or_load(resume=args.resume)
    trainer.train()
    return trainer


def run_rank(local_rank: int, args):
    """Rank ``local_rank`` of this host: joins the group (NCCL on a card,
    gloo on the CPU), runs the command on its device, leaves the group."""
    n = local_ranks(args)
    device = initialize_distributed(
        args.coordinator, args.num_processes * n,
        args.process_id * n + local_rank, device=args.device,
        local_rank=local_rank, always=True,
        model_axis=int(load_config(args.config_file or None,
                                   args.opts).MESH.MODEL))
    try:
        return run(args, device)
    finally:
        shutdown_distributed()


def main(argv: Optional[List[str]] = None):
    """Run the command line. In this process (one rank, or no group):
    return the finished Trainer, or with --eval-only the evaluation's
    results; with several ranks on this host, spawn them and return
    None once all have ended (raising if one failed)."""
    args = parse_args(argv)
    n = local_ranks(args)
    if n < 1:
        raise ValueError(f"--device {args.device}: no card visible")
    if args.num_devices == -1 and args.num_processes == 1 and n == 1:
        return run(args, args.device)
    if n == 1:
        return run_rank(0, args)
    torch.multiprocessing.spawn(run_rank, args=(args,), nprocs=n, join=True)
    return None


if __name__ == "__main__":
    main(sys.argv[1:])
