"""Panoptic pseudo labels for unlabeled video-sequence frames.

    python -m mgnet_tpu_torch.tools.generate_pseudo_labels --config-file
        FILE --output DIR [--dataset NAME] [--data-root DIR] [--weights W]
        [--max-images N] [--batch B] [--gt-instance-dir DIR]
        [--convert-json PATH] [--num-processes N --process-id I
        --coordinator HOST:PORT] [--device cuda] [KEY VALUE ...]

The counterpart of ``tools/generate_pseudo_labels.py``: the dataset is
registered in pseudo-label mode (images only), every frame runs through
the ``Predictor`` (panoptic only; multi-scale + flip TTA where the config
says so) on ``--device``, each panoptic map's trainIds are mapped back to
dataset ids (stuff -> id, things -> id * 1000 + instance, void -> 0) and
written as a uint16 ``*_instanceIds.png``, curated ground truth is copied
over the generated labels, and ``--convert-json`` converts the result to
COCO-panoptic (``data/prepare.py``). KITTI labels keep the drive tree
(``image_`` -> ``label_``).

Frames that share a resized shape run as one device batch of ``--batch``.
The PNG reads and writes run on a thread pool, and the batches run as a
software pipeline of depth one: batch N+1 is enqueued before batch N is
copied to the host. The steady-state rate it prints counts the frames
after the first batch over the time from the second batch's enqueue to
the last write. With ``--num-processes``, each process takes every
N-th frame; after a barrier, process 0 alone copies the curated labels
and converts.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from mgnet_tpu_torch.config import load_config
from mgnet_tpu_torch.data import (
    DatasetCatalog,
    MetadataCatalog,
    read_image,
    register_all_cityscapes_scene_seg,
    register_all_kitti_eigen_scene_seg,
    write_png,
)
from mgnet_tpu_torch.data.prepare import convert2panoptic
from mgnet_tpu_torch.inference import Predictor
from mgnet_tpu_torch.parallel import (
    initialize_distributed,
    is_main_process,
    process_count,
    process_index,
    synchronize,
)

__all__ = ["main", "parse_args", "trainid_to_dataset_id_map"]

# frames of the Cityscapes video-sequence train split, which the
# projected time covers
SEQUENCE_FRAMES = 89250


def trainid_to_dataset_id_map(categories):
    return {c["trainId"]: c["id"] for c in categories}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--dataset",
                   default="cityscapes_scene_seg_train_video_sequence")
    p.add_argument("--data-root", default="./datasets")
    p.add_argument("--weights", default="")
    p.add_argument("--output", required=True)
    p.add_argument("--max-images", type=int, default=0)
    p.add_argument("--batch", type=int, default=4,
                   help="device batch for frames of one resized shape")
    p.add_argument("--gt-instance-dir", default="",
                   help="curated *_instanceIds.png, copied over the "
                        "generated labels")
    p.add_argument("--convert-json", default="",
                   help="convert the labels to COCO-panoptic (PNGs in "
                        "<output>_panoptic, JSON at this path)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--coordinator", default="127.0.0.1:12355")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    initialize_distributed(coordinator_address=args.coordinator,
                           num_processes=args.num_processes,
                           process_id=args.process_id)
    cfg = load_config(args.config_file, args.opts)
    cfg.WITH_DEPTH = False
    if args.weights:
        cfg.MODEL.WEIGHTS = args.weights
    kitti = "kitti" in args.dataset
    register = (register_all_kitti_eigen_scene_seg if kitti
                else register_all_cityscapes_scene_seg)
    register(args.data_root, pseudo_label_generation=True)
    dataset = DatasetCatalog.get(args.dataset)
    if args.max_images:
        dataset = dataset[:args.max_images]
    dataset = dataset[process_index()::process_count()]
    meta = MetadataCatalog.get(args.dataset)
    id_map = trainid_to_dataset_id_map(meta.categories)
    label_divisor = meta.label_divisor

    predictor = Predictor(cfg, dataset_name=args.dataset, device=args.device)
    os.makedirs(args.output, exist_ok=True)

    # trainId -> dataset id and is-thing tables, one past the largest
    # trainId for the clipped void class
    max_tid = max(id_map)
    did_table = np.zeros(max_tid + 2, np.int64)
    isthing_table = np.zeros(max_tid + 2, bool)
    for c in meta.categories:
        did_table[c["trainId"]] = id_map[c["trainId"]]
        isthing_table[c["trainId"]] = bool(c.get("isthing"))

    def remap_and_save(pan: np.ndarray, file_name: str) -> None:
        pan = pan.astype(np.int64)
        cls = np.clip(pan // label_divisor, 0, max_tid + 1)
        did = did_table[cls]
        remapped = np.where(
            pan >= 0,
            np.where(isthing_table[cls], did * 1000 + pan % label_divisor,
                     did),
            0,
        ).astype(np.uint16)
        if kitti:
            # frame numbers repeat across drives: keep the drive tree
            rel = file_name.split("kitti_eigen/")[-1].replace("image_",
                                                              "label_")
            out = os.path.join(args.output,
                               os.path.splitext(rel)[0] + "_instanceIds.png")
            os.makedirs(os.path.dirname(out), exist_ok=True)
        else:
            stem = os.path.splitext(os.path.basename(file_name))[0]
            stem = stem.replace("_leftImg8bit", "")
            out = os.path.join(args.output, f"{stem}_instanceIds.png")
        write_png(out, remapped)

    def load(d):
        img = read_image(d["file_name"])
        t = predictor.mapper._resize(*img.shape[:2])
        return d, t.apply_image(img).astype(np.float32)

    batch_size = max(1, int(args.batch))
    n_done, t0 = 0, time.time()
    flushed = []  # (size, time enqueued) of each batch
    writes = []
    with ThreadPoolExecutor(max(2, batch_size)) as pool:
        buckets = defaultdict(list)
        pending = None  # (output tensors on the device, items)

        def materialize(batch):
            nonlocal n_done
            out, items = batch
            pan = out["panoptic"].cpu().numpy()  # waits for the batch
            for i, (d, _) in enumerate(items):
                writes.append(pool.submit(remap_and_save, pan[i],
                                          d["file_name"]))
            n_done += len(items)

        def flush(items):
            nonlocal pending
            flushed.append((len(items), time.time()))
            out = predictor.predict_batch(
                np.stack([r for _, r in items]), outputs=("panoptic",),
                materialize=False)
            prev, pending = pending, (out, items)
            if prev is not None:
                materialize(prev)

        for d, resized in pool.map(load, dataset):
            key = resized.shape
            buckets[key].append((d, resized))
            if len(buckets[key]) == batch_size:
                flush(buckets.pop(key))
        for key in list(buckets):
            flush(buckets.pop(key))
        if pending is not None:
            materialize(pending)
        for f in writes:
            f.result()
    wall = time.time() - t0
    # the steady window opens when the second batch is enqueued: the
    # first batch's set-up is left out, and its copy to the host, which
    # follows that enqueue, is in, with the rest of its device work (the
    # frame returns before its work is done: nothing in it waits for the
    # card)
    steady = ((n_done - flushed[0][0]) / (time.time() - flushed[1][1])
              if len(flushed) > 1 else n_done / max(wall, 1e-9))
    print(f"Wrote pseudo labels for {len(dataset)} images to "
          f"{args.output} ({wall:.1f} s wall, steady-state "
          f"{steady:.2f} img/s -> projected "
          f"{SEQUENCE_FRAMES / max(steady, 1e-9) / 3600:.1f} h for the "
          f"89,250-frame video-sequence split)", flush=True)

    synchronize()
    if not is_main_process():
        return

    if args.gt_instance_dir:
        # curated labels win; one retry for a transient file-system error
        files = glob.glob(os.path.join(
            args.gt_instance_dir, "**", "*_instanceIds.png"), recursive=True)
        for attempt in range(2):
            try:
                for f in files:
                    shutil.copy(f, os.path.join(args.output,
                                                os.path.basename(f)))
                break
            except OSError:
                if attempt == 1:
                    raise
        print(f"Copied {len(files)} curated gt label files over "
              f"{args.output}")

    if args.convert_json:
        convert2panoptic(args.output, args.output.rstrip("/") + "_panoptic",
                         args.convert_json, kitti=kitti)
    else:
        print("Next: convert the labels with "
              "mgnet_tpu_torch.data.prepare.convert2panoptic (or pass "
              "--convert-json) for COCO-panoptic JSON + RGB PNGs.")


if __name__ == "__main__":
    main(sys.argv[1:])
