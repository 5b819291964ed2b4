"""Throughput of the port's training mapper on the host, by phase.

    python -m mgnet_tpu_torch.tools.bench_mapper [--height 1024]
        [--width 2048] [--iters 12] [--batch 12] [--step-seconds 0.335]
        [--decode-cache]

The counterpart of ``tools/bench_mapper.py``: the default config's
``TrainDatasetMapper`` (the Fine recipe's multi-scale resize of the short
side to 512-2048, 1024x1024 crop with padding, flip and colour jitter)
on a fixture of a 1024x2048 frame, its two sequence frames and a
panoptic label of road, sky and eight cars, written by
``data.image_io.write_png`` with a seeded RNG. Each phase is timed alone
with the same pinned draws:

  decode     4 PNG reads (frame, prev, next, panoptic)
  geometric  the shared transform list on 3 frames + label
  jitter     colour jitter on 3 frames
  targets    rgb2id + PanopticTargetGenerator

and the FULL mapper (a fresh seeded RNG per call) is the real number; the
glue between phases is not attributed. The cores the loader needs to
keep a step fed is ``batch * full / step-seconds``. The mapper runs on the
host (no card); the last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.data import (
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    MetadataCatalog,
    TrainDatasetMapper,
    build_meta,
)
from mgnet_tpu_torch.data.image_io import write_png
from mgnet_tpu_torch.data.mapper import id2rgb, read_image, rgb2id
from mgnet_tpu_torch.data.transforms import sample_color_jitter

__all__ = ["STEP_SECONDS", "main", "make_fixture", "parse_args"]

# the Fine recipe's step at its batch of 12 (1024x1024 crops, bf16) on an
# NVIDIA H100 80GB HBM3 at 700 W, as chip_smoke.py measured it
# (PERF.md section 5)
STEP_SECONDS = 0.335


def make_fixture(root: str, height: int, width: int) -> dict:
    """The dataset dict of one frame under ``root``: three seeded RGB
    frames, a street-scene-like panoptic PNG (road, sky and eight cars)
    with its segments, a Cityscapes camera."""
    rng = np.random.RandomState(42)
    os.makedirs(root, exist_ok=True)
    d = {}
    for name, key in (("cur", "file_name"), ("prev", "prev_img_file_name"),
                      ("next", "next_img_file_name")):
        p = os.path.join(root, f"{name}.png")
        write_png(p, rng.randint(0, 255, (height, width, 3), np.uint8))
        d[key] = p
    pan = np.full((height, width), 7 * 1000, np.int32)
    pan[: height // 4] = 23 * 1000
    segs = [{"id": 7000, "category_id": 1, "iscrowd": 0},
            {"id": 23000, "category_id": 11, "iscrowd": 0}]
    for i in range(8):
        y = height // 3 + (i % 3) * height // 8
        x = (i * width) // 9
        pan[y:y + height // 8, x:x + width // 12] = 26 * 1000 + i + 1
        segs.append({"id": 26000 + i + 1, "category_id": 14, "iscrowd": 0})
    p = os.path.join(root, "pan.png")
    write_png(p, id2rgb(pan))
    d["pan_seg_file_name"] = p
    d["segments_info"] = segs
    d["calibration_info"] = {
        "intrinsic": {"fx": 2262.52, "fy": 2265.3,
                      "u0": (width - 1) / 2, "v0": (height - 1) / 2},
        "extrinsic": {"baseline": 0.222, "z": 1.22},
    }
    d["image_id"] = "bench_000000"
    d["height"], d["width"] = height, width
    return d


def bench(fn, n: int, warmup: int = 2) -> float:
    """Host seconds per call of ``fn()``."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--step-seconds", type=float, default=STEP_SECONDS,
                   help="train-step seconds for the cores-needed row "
                        "(default: the Fine step at batch 12 on an NVIDIA "
                        "H100 80GB HBM3 at 700 W, PERF.md)")
    p.add_argument("--batch", type=int, default=12)
    p.add_argument("--decode-cache", action="store_true",
                   help="enable the disk decode-once cache "
                        "(DATALOADER.DECODE_CACHE_DIR); the bench then "
                        "measures the steady-state (warm-cache) epoch")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    cfg = get_default_config()
    cfg.INPUT.IGNORED_CATEGORIES_IN_DEPTH = ["ego vehicle", "sky"]
    MetadataCatalog.get("mapper_bench").set(
        **build_meta(CITYSCAPES_SCENE_SEG_CATEGORIES))
    with tempfile.TemporaryDirectory() as tdir:
        d = make_fixture(tdir, args.height, args.width)
        if args.decode_cache:
            cfg.DATALOADER.DECODE_CACHE_DIR = os.path.join(tdir, "dcache")
        mapper = TrainDatasetMapper(cfg, dataset_name="mapper_bench")
        it = [0]

        def full():
            it[0] += 1
            return mapper(d, rng=np.random.default_rng(it[0]))

        t_full = bench(full, args.iters)

        rng = np.random.default_rng(1)
        imgs = [read_image(d[k]) for k in
                ("file_name", "prev_img_file_name", "next_img_file_name")]
        tfl = mapper.sampler(rng, imgs[0].shape)
        cj = cfg.INPUT.COLOR_JITTER
        jitter = sample_color_jitter(
            rng, cj.BRIGHTNESS, cj.CONTRAST, cj.SATURATION, cj.HUE)
        t_decode = bench(
            lambda: [mapper._read(d[k]) for k in
                     ("file_name", "prev_img_file_name",
                      "next_img_file_name", "pan_seg_file_name")],
            args.iters)
        pan_rgb_src = read_image(d["pan_seg_file_name"])
        t_geom = bench(
            lambda: ([tfl.apply_image(im) for im in imgs],
                     tfl.apply_segmentation(pan_rgb_src)),
            args.iters)
        aug = [tfl.apply_image(im) for im in imgs]
        t_jit = bench(lambda: [jitter.apply_image(im) for im in aug],
                      args.iters)
        pan_ids = rgb2id(tfl.apply_segmentation(pan_rgb_src))
        t_tgt = bench(lambda: mapper.target_gen(pan_ids, d["segments_info"]),
                      args.iters)

    rows = [("decode 4 PNG", t_decode), ("geometric x3+label", t_geom),
            ("color jitter x3", t_jit), ("targets", t_tgt),
            ("FULL mapper", t_full)]
    for name, t in rows:
        print(f"# {name:20s} {t * 1e3:8.1f} ms/sample", file=sys.stderr)
    cores = args.batch * t_full / args.step_seconds
    print(f"# cores to feed batch-{args.batch} @ {args.step_seconds:.3f} "
          f"s/step: {cores:.1f} (this host has {os.cpu_count()})",
          file=sys.stderr)
    result = {"metric": "train_mapper_ms_per_sample_per_core",
              "value": round(t_full * 1e3, 1), "unit": "ms",
              "phases_ms": {n: round(t * 1e3, 1) for n, t in rows[:-1]},
              "cores_for_batch": round(cores, 1),
              "step_seconds": args.step_seconds}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
