"""Evaluation-loop throughput of the port on a synthetic val split.

    python -m mgnet_tpu_torch.tools.bench_eval_loop [--images 8]
        [--height 512] [--width 1024] [--batch 4] [--workers 4]
        [--device cuda] [KEY VALUE ...]

The counterpart of ``tools/bench_eval_loop.py``: ``evaluate_dataset``
end to end (device batches, the post-processing on the device, the copy
to the host and the host's evaluators) over a raw synthetic Cityscapes
val split (``data.make_synthetic_cityscapes_raw``, ``--images`` frames
of ``--height`` x ``--width``, converted by ``data.prepare``, ``--workers``
processes, 0 for this one), with the Fine YAML's model (bf16) drawn from
seed 0. Two passes: the first pays the cuDNN plans and the allocator's
first requests, the second is the steady number. For each pass it prints
the wall seconds, the images/s that ``evaluate_dataset`` reports and the
bytes copied to the host per image of the device batches (the compacted
outputs: uint8 classes, int16 panoptic ids, float16 center and depth,
padding included); the last line is one JSON object. The dataset
catalogs are cleared first: the split is registered under its own root.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

import torch

import mgnet_tpu_torch.train.trainer as trainer_module
from mgnet_tpu_torch.config import load_config
from mgnet_tpu_torch.data import (
    DatasetCatalog,
    MetadataCatalog,
    make_synthetic_cityscapes_raw,
    register_all_cityscapes_scene_seg,
)
from mgnet_tpu_torch.data.prepare import convert2panoptic
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.utils.profiling import device_line, require_device

__all__ = ["main", "parse_args"]

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--workers", type=int, default=4,
                   help="processes of the panoptic conversion (0: this "
                        "process)")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="further config overrides (KEY VALUE ...)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    device = require_device(args.device)
    with tempfile.TemporaryDirectory(prefix="mgnet_evalbench_") as root:
        make_synthetic_cityscapes_raw(root, "val", n_images=args.images,
                                      height=args.height, width=args.width)
        gt = os.path.join(root, "cityscapes", "gtFine")
        out_dir = os.path.join(gt, "cityscapes_panoptic_val")
        convert2panoptic(os.path.join(gt, "val"), out_dir,
                         out_dir + ".json", args.workers)
        DatasetCatalog.clear()
        MetadataCatalog.clear()
        register_all_cityscapes_scene_seg(root)
        cfg = load_config(
            os.path.join(REPO, "configs", "MGNet-Cityscapes-Fine.yaml"), [
                "MODEL.WEIGHTS", "",
                "INPUT.MIN_SIZE_TEST", str(args.height),
                "INPUT.MAX_SIZE_TEST", str(args.width),
                "TEST.IMS_PER_BATCH", str(args.batch),
                *args.opts])
        model = build_model(cfg, device="cpu")
        init_random_(model, torch.Generator().manual_seed(0))
        model.to(device)
        print(device_line(device), file=sys.stderr)

        copied = {"bytes": 0, "images": 0}
        to_host = trainer_module.to_host

        def counting(res):
            copied["bytes"] += sum(v.numel() * v.element_size()
                                   for v in res.values())
            copied["images"] += next(iter(res.values())).shape[0]
            return to_host(res)

        passes = {}
        trainer_module.to_host = counting
        try:
            for label in ("cold", "steady"):
                copied.update(bytes=0, images=0)
                t0 = time.perf_counter()
                results = trainer_module.evaluate_dataset(cfg, model)
                wall = time.perf_counter() - t0
                speed = results.get("eval_speed", {})
                per_image = copied["bytes"] / max(copied["images"], 1)
                passes[label] = {
                    "wall_s": round(wall, 3),
                    "images_per_s": round(speed.get("images_per_s", 0.0),
                                          3),
                    "host_bytes_per_image": per_image}
                print(f"# {label}: wall {wall:.1f} s, "
                      f"{speed.get('images_per_s', 0):.2f} img/s "
                      f"({int(speed.get('num_images', 0))} images), "
                      f"{per_image:.0f} bytes to the host per image",
                      file=sys.stderr, flush=True)
        finally:
            trainer_module.to_host = to_host
            DatasetCatalog.clear()
            MetadataCatalog.clear()
    result = {"metric": "eval_loop_images_per_s",
              "value": passes["steady"]["images_per_s"],
              "images": args.images, "hw": [args.height, args.width],
              "batch": args.batch, "passes": passes, "device": str(device)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
