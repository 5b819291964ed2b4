"""Worker of the port's 2-process evaluation test (test_torch_eval_e2e.py).

    python _torch_mp_eval_worker.py RANK PORT TREE

Joins a gloo group of two on localhost, evaluates its strided half of the
mini val tree under TREE with a seeded narrow model on the CPU, and prints
``RESULT <json>`` of the merged results. ``evaluate`` is also the
one-process reference.
"""

from __future__ import annotations

import json
import sys


def evaluate(tree: str):
    import torch

    import mgnet_tpu_torch.data as tdata
    from mgnet_tpu_torch.config import get_default_config
    from mgnet_tpu_torch.models import build_model, init_random_
    from mgnet_tpu_torch.train.trainer import evaluate_dataset

    cfg = get_default_config()
    cfg.MODEL.COMPUTE_DTYPE = "float32"
    cfg.MODEL.GCM.GCM_CHANNELS = 32
    h = cfg.MODEL.SEM_SEG_HEAD
    h.ARM_CHANNELS, h.REFINE_CHANNELS = [32, 32], [32, 32]
    h.FFM_CHANNELS, h.HEAD_CHANNELS = 48, 32
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 64, 128
    cfg.TEST.IMS_PER_BATCH = 2
    cfg.TEST.EVAL_INSTANCE = True
    cfg.MODEL.POST_PROCESSING.MAX_INSTANCES = 16
    cfg.DATALOADER.NUM_WORKERS = 2
    if "cityscapes_fine_scene_seg_val" not in tdata.DatasetCatalog.list():
        tdata.register_all_cityscapes_scene_seg(tree)
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(17))
    return evaluate_dataset(cfg, model)


def main(rank: int, port: int, tree: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        print("RESULT " + json.dumps(evaluate(tree)), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
