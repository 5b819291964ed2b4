"""Cityscapes scene-segmentation dataset registry.

A copy of ``mgnet_tpu/data/cityscapes.py``: three splits (fine train,
video-sequence train with pseudo labels, val); prev/next sequence frames
resolved by frame-index arithmetic; disparity + per-drive camera JSON;
COCO-panoptic ground truth (id2rgb PNG + JSON); metadata with
label_divisor=1000, ignore_label=255. Reads JSON with the standard library.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from mgnet_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from mgnet_tpu_torch.data.categories import (
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    build_meta,
)

__all__ = ["register_all_cityscapes_scene_seg", "load_cityscapes_scene_seg"]

_SPLITS = {
    "cityscapes_fine_scene_seg_train": (
        "cityscapes/leftImg8bit/train",
        "cityscapes/leftImg8bit_sequence/train",
        "cityscapes/camera/train",
        "cityscapes/disparity/train",
        "cityscapes/gtFine/cityscapes_panoptic_train",
        "cityscapes/gtFine/cityscapes_panoptic_train.json",
    ),
    "cityscapes_scene_seg_train_video_sequence": (
        "cityscapes/leftImg8bit_sequence/train",
        "cityscapes/leftImg8bit_sequence/train",
        "cityscapes/camera/train",
        "cityscapes/disparity/train",
        "cityscapes/gtFine_sequence/cityscapes_panoptic_train",
        "cityscapes/gtFine_sequence/cityscapes_panoptic_train.json",
    ),
    "cityscapes_fine_scene_seg_val": (
        "cityscapes/leftImg8bit/val",
        "cityscapes/leftImg8bit_sequence/val",
        "cityscapes/camera/val",
        "cityscapes/disparity/val",
        "cityscapes/gtFine/cityscapes_panoptic_val",
        "cityscapes/gtFine/cityscapes_panoptic_val.json",
    ),
}

_FRAME_DIGITS = 6  # frame index width in cityscapes file names


def _sequence_neighbors(image_file: str, seq_dir: str):
    """Resolve prev/next frame paths via frame-index arithmetic.

    Cityscapes names: {city}_{seq:06d}_{frame:06d}_leftImg8bit.png
    (parity: reference cityscapes_scene_seg.py:139-153).
    """
    rel = "/".join(image_file.split("/")[-2:])
    seq_file = os.path.join(seq_dir, rel)
    base = os.path.basename(seq_file)
    stem = base.replace("_leftImg8bit.png", "")
    city, seq, frame = stem.rsplit("_", 2)
    idx = int(frame)

    def at(i):
        return os.path.join(
            os.path.dirname(seq_file),
            f"{city}_{seq}_{i:0{_FRAME_DIGITS}d}_leftImg8bit.png",
        )

    return at(idx - 1), at(idx + 1)


def _drive_camera_info(camera_dir: str, image_file: str) -> Dict:
    """Camera intrinsics JSON for the drive containing ``image_file``.

    The per-frame camera file may not exist for sequence frames; intrinsics
    are constant per drive so any file in the drive folder works
    (parity: reference :155-169).
    """
    rel_dir = image_file.split("/")[-2]
    drive_dir = os.path.join(camera_dir, rel_dir)
    candidates = sorted(os.listdir(drive_dir))
    with open(os.path.join(drive_dir, candidates[0])) as f:
        return json.load(f)


def load_cityscapes_scene_seg(
    image_dir: str,
    image_seq_dir: str,
    camera_dir: str,
    disparity_dir: str,
    gt_dir: str,
    gt_json: str,
    meta: Dict,
    pseudo_label_generation: bool = False,
) -> List[dict]:
    """Build the per-image dataset dicts (reference :78-230)."""
    thing_map = meta["thing_dataset_id_to_contiguous_id"]
    stuff_map = meta["stuff_dataset_id_to_contiguous_id"]

    def convert_seg(seg):
        cid = seg["category_id"]
        seg = dict(seg)
        seg["category_id"] = thing_map.get(cid, stuff_map.get(cid, cid))
        return seg

    entries = []
    if pseudo_label_generation:
        for path, _, names in os.walk(image_dir):
            for n in sorted(names):
                entries.append((os.path.join(path, n), "", []))
    else:
        assert os.path.exists(gt_json), (
            f"Missing panoptic gt json {gt_json}; run "
            "tools/prepare_cityscapes.py first."
        )
        with open(gt_json) as f:
            info = json.load(f)
        for ann in info["annotations"]:
            label_file = os.path.join(gt_dir, ann["file_name"])
            # {city}_{seq}_{frame}_gtFine_panoptic.png -> image path
            stem = ann["file_name"].replace("_gtFine_panoptic.png", "")
            stem = stem.replace("_panoptic.png", "")
            city = stem.split("_")[0]
            image_file = os.path.join(
                image_dir, city, stem + "_leftImg8bit.png"
            )
            entries.append((image_file, label_file, ann["segments_info"]))

    is_train = "train" in os.path.basename(gt_dir)
    ret = []
    for image_file, label_file, segments_info in entries:
        prev_f, next_f = _sequence_neighbors(image_file, image_seq_dir)
        if is_train and not (os.path.exists(prev_f) and os.path.exists(next_f)):
            continue  # first/last frame of a sequence
        rel = "/".join(image_file.split("/")[-2:])
        disparity_file = os.path.join(disparity_dir, rel).replace(
            "_leftImg8bit.png", "_disparity.png"
        )
        calibration_info = _drive_camera_info(camera_dir, image_file)
        sem_label_file = (
            image_file.replace("leftImg8bit", "gtFine").split(".")[0]
            + "_labelTrainIds.png"
        )
        ret.append(
            dict(
                file_name=image_file,
                image_id="_".join(
                    os.path.splitext(os.path.basename(image_file))[0]
                    .split("_")[:3]
                ),
                sem_seg_file_name=sem_label_file,
                pan_seg_file_name=label_file,
                disparity_file_name=disparity_file,
                prev_img_file_name=prev_f,
                next_img_file_name=next_f,
                segments_info=[convert_seg(s) for s in segments_info],
                calibration_info=calibration_info,
            )
        )
    assert ret, f"No images found in {image_dir}"
    return ret


def register_all_cityscapes_scene_seg(root: str,
                                      pseudo_label_generation: bool = False):
    meta = build_meta(CITYSCAPES_SCENE_SEG_CATEGORIES)
    for key, dirs in _SPLITS.items():
        paths = [os.path.join(root, d) for d in dirs]

        def loader(paths=paths):
            return load_cityscapes_scene_seg(
                *paths, meta=meta,
                pseudo_label_generation=pseudo_label_generation,
            )

        DatasetCatalog.register(key, loader)
        MetadataCatalog.get(key).set(
            image_root=paths[0],
            panoptic_root=paths[4],
            panoptic_json=paths[5],
            gt_dir=paths[4].replace("cityscapes_panoptic_", ""),
            evaluator_type="cityscapes_scene_seg",
            **meta,
        )
