"""Overfit validation: panoptic PQ must approach 100 on the training scenes.

    python -m mgnet_tpu_torch.tools.validate_overfit [--steps 1200]
        [--lr 1e-3] [--batch 2] [--accum 1] [--device cuda]

The counterpart of ``tools/validate_overfit.py``, the strongest data-free
check of the whole training stack: if the losses, the target generation,
the augmentation bookkeeping, the panoptic fusion and the PQ evaluation
agree, a model trained on a few scenes reproduces their own ground truth.
It writes ``N_SCENES`` structured synthetic scenes in the Cityscapes
layout (``make_dataset``, through ``data.image_io.write_png``), trains the
panoptic-only model on them from the seeded init with the port's
``Trainer`` on ``--device``, evaluates them with ``evaluate_dataset``,
prints the loss trajectory and the JSON of PQ, PQ_things, PQ_stuff and
mIoU, and passes when PQ > 80 and mIoU > 80 (exit code 0; 1 otherwise).
The scenes live in a temporary directory removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np

from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.data import DatasetCatalog
from mgnet_tpu_torch.data.cityscapes import register_all_cityscapes_scene_seg
from mgnet_tpu_torch.data.image_io import write_png
from mgnet_tpu_torch.data.mapper import id2rgb
from mgnet_tpu_torch.train.trainer import Trainer, evaluate_dataset

__all__ = ["N_SCENES", "main", "make_dataset", "overfit_config",
           "register_scenes"]

N_SCENES = 6


def make_dataset(root: str, h: int = 128, w: int = 256) -> None:
    """Six structured scenes (distinct layouts and colours over the same
    classes: road, sky and two cars) in the Cityscapes layout under
    ``root/cityscapes``: the JAX tool's scenes, from the same seeds. One
    scene at batch 2 would let the network fit its own per-batch BN
    statistics, which the running averages of the evaluation cannot
    follow; several keep the batch statistics representative."""
    city = "overfit"
    dirs = {
        "img": f"{root}/cityscapes/leftImg8bit/train/{city}",
        "seq": f"{root}/cityscapes/leftImg8bit_sequence/train/{city}",
        "cam": f"{root}/cityscapes/camera/train/{city}",
        "disp": f"{root}/cityscapes/disparity/train/{city}",
        "gt": f"{root}/cityscapes/gtFine/cityscapes_panoptic_train",
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    anns = []
    for sc in range(N_SCENES):
        rng = np.random.RandomState(42 + sc)
        img = np.zeros((h, w, 3), np.uint8)
        base = tuple(int(v) for v in rng.randint(70, 150, 3))
        sky = tuple(int(v) for v in rng.randint(180, 255, 3))
        img[:, :] = base
        hor = h // 3 + int(rng.randint(-10, 10))
        img[:hor] = sky
        pan = np.full((h, w), 1 * 1000, np.int32)   # road (trainId 1)
        pan[:hor] = 11 * 1000                       # sky (trainId 11)
        for inst in (1, 2):  # cars (trainId 14, dataset id 26)
            ch, cw = int(rng.randint(30, 45)), int(rng.randint(40, 70))
            y0 = int(rng.randint(hor + 2, h - ch - 2))
            x0 = int(rng.randint(2, w - cw - 2))
            pan[y0:y0 + ch, x0:x0 + cw] = 26 * 1000 + inst
            img[y0:y0 + ch, x0:x0 + cw] = tuple(
                int(v) for v in rng.randint(0, 255, 3))
        img = np.clip(
            img.astype(int) + rng.randint(-12, 12, img.shape), 0, 255
        ).astype(np.uint8)

        stem = f"{city}_{sc:06d}_000010"
        write_png(f"{dirs['img']}/{stem}_leftImg8bit.png", img)
        for i in (9, 10, 11):
            write_png(f"{dirs['seq']}/{city}_{sc:06d}_{i:06d}"
                      "_leftImg8bit.png", img)
        write_png(f"{dirs['gt']}/{stem}_gtFine_panoptic.png", id2rgb(pan))

        def seg(pid, cat):
            return {"id": pid, "category_id": cat, "iscrowd": 0,
                    "area": int((pan == pid).sum())}

        anns.append({
            "image_id": stem,
            "file_name": f"{stem}_gtFine_panoptic.png",
            "segments_info": [seg(1000, 7), seg(11000, 23),
                              seg(26001, 26), seg(26002, 26)],
        })
        with open(f"{dirs['cam']}/{stem}_camera.json", "w") as f:
            json.dump({"intrinsic": {"fx": 226.0, "fy": 226.0,
                                     "u0": (w - 1) / 2,
                                     "v0": (h - 1) / 2},
                       "extrinsic": {"baseline": 0.2, "z": 1.2}}, f)

    with open(f"{root}/cityscapes/gtFine/cityscapes_panoptic_train.json",
              "w") as f:
        json.dump({"annotations": anns, "categories": []}, f)


def register_scenes(root: str) -> None:
    """Register the Cityscapes splits at ``root`` in this process, in
    place of any earlier registration of them."""
    for name in DatasetCatalog.list():
        if name.startswith("cityscapes_"):
            DatasetCatalog.remove(name)
    register_all_cityscapes_scene_seg(root)


def overfit_config(steps: int, lr: float, batch: int, accum: int,
                   output_dir: str):
    """The JAX tool's overrides (``tools/validate_overfit.py:114-142``) on
    the default config: panoptic only, no augmentation, 128x256, the
    training scenes as the test split."""
    cfg = get_default_config()
    cfg.WITH_DEPTH = False
    cfg.WITH_UNCERTAINTY = False
    cfg.MODEL.SEM_SEG_HEAD.OHEM_N_MIN = 2047
    cfg.SOLVER.MAX_ITER = steps
    cfg.SOLVER.BASE_LR = lr
    cfg.SOLVER.IMS_PER_BATCH = batch
    cfg.SOLVER.GRAD_ACCUM_STEPS = accum
    cfg.SOLVER.WARMUP_ITERS = 20
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 ** 9
    cfg.TEST.EVAL_PERIOD = 0
    cfg.INPUT.MIN_SIZE_TRAIN = (128,)
    cfg.INPUT.MAX_SIZE_TRAIN = 256
    cfg.INPUT.CROP.ENABLED = False
    cfg.INPUT.COLOR_JITTER.ENABLED = False
    cfg.INPUT.RANDOM_FLIP = "none"
    cfg.INPUT.MIN_SIZE_TEST = 128
    cfg.INPUT.MAX_SIZE_TEST = 256
    cfg.MODEL.POST_PROCESSING.MAX_INSTANCES = 16
    cfg.MODEL.POST_PROCESSING.STUFF_AREA = 64
    cfg.DATASETS.TRAIN = ("cityscapes_fine_scene_seg_train",)
    cfg.DATASETS.TEST = ("cityscapes_fine_scene_seg_train",)
    cfg.DATALOADER.NUM_WORKERS = 2
    cfg.OUTPUT_DIR = output_dir
    cfg.MESH.DATA = 1
    return cfg


def print_trajectory(output_dir: str, keys, parts: int) -> None:
    """About ``parts`` evenly spaced records of ``metrics.json``, rounded
    to 4 places, restricted to ``keys``."""
    path = os.path.join(output_dir, "metrics.json")
    if not os.path.exists(path):
        return
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    for rec in lines[:: max(1, len(lines) // parts)]:
        print({k: round(v, 4) for k, v in rec.items() if k in keys})


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=1200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch", type=int, default=2,
                   help="SOLVER.IMS_PER_BATCH (global batch)")
    p.add_argument("--accum", type=int, default=1,
                   help="SOLVER.GRAD_ACCUM_STEPS")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="mgnet_overfit_") as tmp:
        make_dataset(tmp)
        register_scenes(tmp)
        cfg = overfit_config(args.steps, args.lr, args.batch, args.accum,
                             os.path.join(tmp, "out"))
        trainer = Trainer(cfg, device=args.device)
        trainer.train()
        print_trajectory(cfg.OUTPUT_DIR, ("iteration", "loss_total",
                                          "loss_sem_seg", "loss_center",
                                          "loss_offset"), 10)
        results = evaluate_dataset(cfg, trainer.state.params.model)
    pq = results["panoptic_seg"]["PQ"]
    miou = results["sem_seg"]["mIoU"]
    print(json.dumps({
        "PQ": pq, "PQ_things": results["panoptic_seg"]["PQ_th"],
        "PQ_stuff": results["panoptic_seg"]["PQ_st"], "mIoU": miou,
    }, indent=2))
    ok = pq > 80 and miou > 80
    print("OVERFIT VALIDATION:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
