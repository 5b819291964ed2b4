"""Convert instanceIds PNGs to COCO-panoptic PNGs and JSON.

The port's copy of ``datasets/prepare_cityscapes.py`` and
``datasets/prepare_kitti_eigen.py`` (``convert_one``,
``convert2panoptic``), which read and write through Pillow: here the
16-bit grey instanceIds PNG is read by ``image_io.read_png`` and the
``id2rgb`` panoptic PNG written by ``write_png``. For every
``*_instanceIds.png`` under the input directory, one panoptic PNG and
one ``segments_info`` entry per segment: a raw id below 1000 is a stuff
class (or a thing without an instance index: ``iscrowd``), a larger one
a thing instance of class ``id // 1000``; ids of no known category are
void. Cityscapes names each output ``<stem>_panoptic.png`` in one flat
directory; KITTI keeps the drive tree (``<date>/<drive>/label_02/data/
<frame>.png``, relative to the input root) so that the registry maps each
annotation back to its image through ``label_`` -> ``image_``.
"""

from __future__ import annotations

import glob
import json
import multiprocessing
import os

import numpy as np

from mgnet_tpu_torch.data.categories import CITYSCAPES_SCENE_SEG_CATEGORIES
from mgnet_tpu_torch.data.image_io import read_png, write_png
from mgnet_tpu_torch.data.mapper import id2rgb

__all__ = ["convert2panoptic", "convert_one", "convert_one_kitti"]

THING_IDS = {c["id"] for c in CITYSCAPES_SCENE_SEG_CATEGORIES if c["isthing"]}
KNOWN_IDS = {c["id"] for c in CITYSCAPES_SCENE_SEG_CATEGORIES}


def _segments(in_path: str):
    """(the id2rgb panoptic image, segments_info) of one instanceIds PNG."""
    inst = read_png(in_path)
    if inst.ndim == 3:
        inst = inst[..., 0]  # an 8-bit grey PNG decodes as RGB
    pan = np.zeros(inst.shape, np.int64)
    segments = []
    for raw_id in np.unique(inst):
        raw_id = int(raw_id)
        if raw_id < 1000:
            category_id, iscrowd = raw_id, int(raw_id in THING_IDS)
        else:
            category_id, iscrowd = raw_id // 1000, 0
        if category_id not in KNOWN_IDS:
            continue  # unlabeled / void
        mask = inst == raw_id
        pan[mask] = raw_id
        ys, xs = np.nonzero(mask)
        segments.append({
            "id": raw_id,
            "category_id": category_id,
            "area": int(mask.sum()),
            "bbox": [int(xs.min()), int(ys.min()),
                     int(xs.max() - xs.min() + 1),
                     int(ys.max() - ys.min() + 1)],
            "iscrowd": iscrowd,
        })
    return id2rgb(pan), segments


def convert_one(args):
    """(in_path, out_dir) -> the Cityscapes annotation dict; writes
    ``out_dir/<stem>_panoptic.png``."""
    in_path, out_dir = args
    rgb, segments = _segments(in_path)
    stem = os.path.basename(in_path).replace("_instanceIds.png", "")
    out_name = f"{stem}_panoptic.png"
    write_png(os.path.join(out_dir, out_name), rgb)
    return {"image_id": stem, "file_name": out_name,
            "segments_info": segments}


def convert_one_kitti(args):
    """(in_path, input_dir, output_dir) -> the KITTI annotation dict, whose
    ``file_name`` is the path relative to ``input_dir`` without the
    ``_instanceIds`` suffix (bare frame numbers collide across drives);
    writes the panoptic PNG there under ``output_dir``."""
    in_path, input_dir, output_dir = args
    rgb, segments = _segments(in_path)
    file_name = os.path.relpath(in_path, input_dir).replace(
        "_instanceIds.png", ".png")
    out_path = os.path.join(output_dir, file_name)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    write_png(out_path, rgb)
    return {"image_id": os.path.splitext(file_name)[0].replace("/", "_"),
            "file_name": file_name, "segments_info": segments}


def convert2panoptic(input_dir: str, output_dir: str, json_path: str,
                     workers: int = 8, kitti: bool = False) -> None:
    """Convert every ``*_instanceIds.png`` under ``input_dir`` (sorted)
    into ``output_dir`` and write the COCO-panoptic JSON (annotations and
    the 20 scene-seg categories) to ``json_path``. ``workers`` processes
    (spawned) convert the files; 0 converts them in this process."""
    os.makedirs(output_dir, exist_ok=True)
    files = sorted(glob.glob(
        os.path.join(input_dir, "**", "*_instanceIds.png"), recursive=True))
    if not files:
        raise FileNotFoundError(f"No *_instanceIds.png under {input_dir}")
    if kitti:
        fn, jobs = convert_one_kitti, [(f, input_dir, output_dir)
                                       for f in files]
    else:
        fn, jobs = convert_one, [(f, output_dir) for f in files]
    if workers > 0:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(workers, len(jobs))) as pool:
            annotations = pool.map(fn, jobs)
    else:
        annotations = [fn(job) for job in jobs]
    categories = [
        {"id": c["id"], "name": c["name"], "color": list(c["color"]),
         "supercategory": "", "isthing": c["isthing"]}
        for c in CITYSCAPES_SCENE_SEG_CATEGORIES
    ]
    with open(json_path, "w") as f:
        json.dump({"annotations": annotations, "categories": categories}, f)
    print(f"Converted {len(files)} label files -> {json_path}")
