"""The training loop: data, the train step, checkpoints and weights.

Port of ``Trainer.__init__``, ``resume_or_load`` and ``train`` of
``mgnet_tpu/train/trainer.py``, on one card: the model and train state
from the config, the mapper named by ``INPUT.TRAIN_DATASET_MAPPER``, the
threaded ``TrainLoader`` over ``DATASETS.TRAIN[0]`` (pinned batches, copied
to the card without blocking), ``make_train_step``, step checkpoints every
``SOLVER.CHECKPOINT_PERIOD`` iterations and at the end, then the
params-only ``model_final``.

As in the JAX trainer, every ``train()`` starts the loader at epoch 0: a
resumed run continues the step count, the optimizer and the schedule, not
the sample stream.

Evaluation (``Trainer.test``, ``evaluate_dataset``) is not ported yet:
``TEST.EVAL_PERIOD > 0`` raises in ``__init__`` and ``test`` raises, so
that no run skips it silently.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch

from mgnet_tpu_torch.data import DatasetCatalog, TrainLoader, to_device
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.train.state import create_train_state
from mgnet_tpu_torch.train.step import make_train_step
from mgnet_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    load_params,
    save_params,
)
from mgnet_tpu_torch.utils.events import MetricLogger
from mgnet_tpu_torch.utils.loader import locate
from mgnet_tpu_torch.utils.profiling import peak_hbm_gb
from mgnet_tpu_torch.utils.weights import load_pretrained_npz

__all__ = ["EVAL_NOT_PORTED", "Trainer"]

EVAL_NOT_PORTED = (
    "evaluation (Trainer.test, evaluate_dataset) is not ported to "
    "mgnet_tpu_torch yet; it comes with the port's evaluation slice. Train "
    "without periodic evaluation with the override TEST.EVAL_PERIOD 0.")


class Trainer:
    """One card's training loop. ``device`` defaults to the card; the tests
    pass ``"cpu"``."""

    def __init__(self, cfg, output_dir: Optional[str] = None,
                 device="cuda"):
        if cfg.TEST.EVAL_PERIOD > 0:
            raise NotImplementedError(
                f"TEST.EVAL_PERIOD={cfg.TEST.EVAL_PERIOD}: " + EVAL_NOT_PORTED)
        self.cfg = cfg
        self.device = torch.device(device)
        self.output_dir = output_dir or cfg.OUTPUT_DIR
        os.makedirs(self.output_dir, exist_ok=True)

        batch = cfg.SOLVER.IMS_PER_BATCH
        accum = max(1, int(cfg.SOLVER.GRAD_ACCUM_STEPS))
        if batch % accum:
            raise ValueError(f"IMS_PER_BATCH={batch} must divide into "
                             f"{accum} GRAD_ACCUM_STEPS micro-batches")
        # weights drawn on the CPU from the seed: the same on every device
        model = build_model(cfg, device="cpu", for_training=True)
        init_random_(model, torch.Generator().manual_seed(cfg.SEED))
        self.state = create_train_state(cfg, model.to(self.device))
        self.train_step = make_train_step(cfg)
        self.ckpt = CheckpointManager(
            os.path.join(self.output_dir, "checkpoints"))
        self.logger = MetricLogger(self.output_dir)

        dataset_name = cfg.DATASETS.TRAIN[0]
        dataset = DatasetCatalog.get(dataset_name)
        mapper = locate(cfg.INPUT.TRAIN_DATASET_MAPPER)(
            cfg, dataset_name=dataset_name)
        self.loader = TrainLoader(
            dataset, mapper, batch_size=batch, seed=cfg.SEED,
            num_workers=cfg.DATALOADER.NUM_WORKERS,
            prefetch=cfg.DATALOADER.PREFETCH,
            divisibility=cfg.MODEL.SIZE_DIVISIBILITY,
            pin_memory=self.device.type == "cuda",
        )
        # the npz graft's {"matched", "skipped"}, once resume_or_load did one
        self.pretrained: Optional[Dict[str, int]] = None
        # host seconds of each iteration of the last train(): waiting on
        # the loader, writing a checkpoint (0 where none), and in all
        self.data_seconds: list = []
        self.save_seconds: list = []
        self.iter_seconds: list = []

    def resume_or_load(self, resume: bool = True):
        """Resume from the latest checkpoint when ``resume`` and one exists;
        else load MODEL.WEIGHTS: a ``model_final``-style directory grafted
        leaf by leaf where name and shape match (a mismatched leaf, such as
        KITTI's 19-class head against Fine's 20, keeps its fresh init;
        zero matches raise), or an npz of ImageNet weights (with or
        without the suffix; a configured but absent file raises)."""
        if resume:
            self.state, restored = self.ckpt.restore(self.state)
            if restored:
                print(f"Resumed from step {self.state.step}")
                return
        weights = self.cfg.MODEL.WEIGHTS
        if not weights:
            return
        if os.path.isdir(weights):
            src = load_params(weights)
            dst = self.state.params.state_dict()
            take = {k: v for k, v in src.items()
                    if k in dst and v.shape == dst[k].shape}
            skipped = sorted(set(src) - set(take))
            if not take:
                raise ValueError(
                    f"MODEL.WEIGHTS={weights!r} (checkpoint dir) matched "
                    "zero parameter leaves; wrong checkpoint or "
                    "incompatible model.")
            with torch.no_grad():
                for k, v in take.items():
                    dst[k].copy_(v)
            print(f"Loaded checkpoint weights from {weights}: {len(take)} "
                  "leaves" + (f", skipped {len(skipped)} (shape/name "
                              f"mismatch): {skipped[:6]}..." if skipped
                              else ""))
            return
        candidates = [weights]
        if not weights.endswith(".npz"):
            candidates.insert(0, weights + ".npz")
        path = next((p for p in candidates if os.path.exists(p)), None)
        if path is None:
            raise FileNotFoundError(
                f"MODEL.WEIGHTS={weights!r} not found (tried {candidates}); "
                "run tools/initialize_weights.sh or clear MODEL.WEIGHTS to "
                "train from scratch.")
        info = load_pretrained_npz(path, self.state.params)
        if info["matched"] == 0:
            raise ValueError(
                f"MODEL.WEIGHTS={path!r} matched zero parameter leaves "
                f"({info}); wrong file or incompatible model.")
        self.pretrained = info
        print(f"Loaded pretrained weights from {path}: {info}")

    def train(self):
        cfg = self.cfg
        max_iter = cfg.SOLVER.MAX_ITER
        start = self.state.step
        it = iter(self.loader)
        self.data_seconds, self.save_seconds, self.iter_seconds = [], [], []
        t_last = time.time()
        try:
            for i in range(start, max_iter):
                t0 = time.perf_counter()
                batch = to_device(next(it), self.device)
                self.data_seconds.append(time.perf_counter() - t0)
                self.state, metrics = self.train_step(self.state, batch)
                if (i + 1) % 20 == 0 or i == start:
                    host = {k: float(v) for k, v in metrics.items()}
                    host["iter_time"] = (time.time() - t_last) / 20
                    host["data_time"] = (sum(self.data_seconds[-20:])
                                         / len(self.data_seconds[-20:]))
                    t_last = time.time()
                    self.logger.log(i + 1, host)
                t1 = time.perf_counter()
                if ((i + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0
                        or i + 1 == max_iter):
                    self.ckpt.save(i + 1, self.state)
                self.save_seconds.append(time.perf_counter() - t1)
                self.iter_seconds.append(time.perf_counter() - t0)
            peak = peak_hbm_gb(self.device)
            if peak is not None:
                self.logger.log(max_iter, {"peak_hbm_gb": peak})
            save_params(os.path.join(self.output_dir, "model_final"),
                        self.state.params)
        finally:
            self.loader.close()

    def test(self) -> Dict[str, Dict[str, float]]:
        raise NotImplementedError(EVAL_NOT_PORTED)
