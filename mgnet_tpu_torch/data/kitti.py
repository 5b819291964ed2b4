"""KITTI Eigen scene-segmentation dataset registry.

A copy of ``mgnet_tpu/data/kitti.py``: splits from the eigen_zhou /
eigen_test txt lists; panoptic pseudo labels required for training;
prev/next frame via zero-padded index; intrinsics parsed from KITTI's
``calib_cam_to_cam.txt`` (P_rect_0x) with numpy; fixed extrinsics
(baseline 0.54 m, camera height 1.65 m); the 19 Cityscapes classes unless
registering for pseudo-label generation (the 20-class scene-seg set).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from mgnet_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from mgnet_tpu_torch.data.categories import (
    CITYSCAPES_CATEGORIES,
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    build_meta,
)

__all__ = ["register_all_kitti_eigen_scene_seg", "load_kitti_eigen_scene_seg"]

_SPLITS = {
    "kitti_zhou_scene_seg_train": (
        "kitti_eigen/data_splits/eigen_zhou_files.txt",
        "kitti_eigen/panoptic_pseudo_labels/eigen_zhou_files_panoptic",
        "kitti_eigen/panoptic_pseudo_labels/eigen_zhou_files_panoptic.json",
    ),
    "kitti_eigen_scene_seg_test": (
        "kitti_eigen/data_splits/eigen_test_files.txt",
        "kitti_eigen/panoptic_pseudo_labels/eigen_test_files_panoptic",
        "kitti_eigen/panoptic_pseudo_labels/eigen_test_files_panoptic.json",
    ),
}

_CAM_DIRS = ("image_02", "image_03")
_FRAME_DIGITS = 10


def read_kitti_calib(folder: str) -> Dict[str, np.ndarray]:
    """Parse ``calib_cam_to_cam.txt`` into float arrays (skips dates)."""
    data: Dict[str, np.ndarray] = {}
    with open(os.path.join(folder, "calib_cam_to_cam.txt")) as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            try:
                data[key.strip()] = np.array(
                    [float(x) for x in value.split()]
                )
            except ValueError:
                pass
    return data


def _intrinsics_for(image_file: str, calib: Dict[str, np.ndarray]) -> np.ndarray:
    for cam in _CAM_DIRS:
        if cam in image_file:
            key = cam.replace("image", "P_rect")
            return calib[key].reshape(3, 4)[:, :3]
    raise ValueError(f"Cannot determine camera for {image_file}")


def _depth_file_for(image_file: str) -> str:
    for cam in _CAM_DIRS:
        if cam in image_file:
            return image_file.replace(
                f"{cam}/data", f"proj_depth/groundtruth/{cam}"
            )
    raise ValueError(f"Cannot determine camera for {image_file}")


def _neighbors(image_file: str):
    base = os.path.basename(image_file)
    stem, ext = os.path.splitext(base)
    idx = int(stem)

    def at(i):
        return os.path.join(
            os.path.dirname(image_file), f"{i:0{_FRAME_DIGITS}d}{ext}"
        )

    return at(idx - 1), at(idx + 1)


def load_kitti_eigen_scene_seg(
    root: str,
    image_split_file: str,
    gt_dir: str,
    gt_json: str,
    meta: Dict,
    pseudo_label_generation: bool = False,
) -> List[dict]:
    thing_map = meta["thing_dataset_id_to_contiguous_id"]
    stuff_map = meta["stuff_dataset_id_to_contiguous_id"]

    def convert_seg(seg):
        cid = seg["category_id"]
        seg = dict(seg)
        seg["category_id"] = thing_map.get(cid, stuff_map.get(cid, cid))
        return seg

    with open(image_split_file) as f:
        files = [(line.split(" ")[0], "", []) for line in f.read().splitlines()]

    is_train = ("train" in os.path.basename(gt_dir)
                or "zhou" in os.path.basename(gt_dir))
    if not pseudo_label_generation and is_train:
        assert os.path.exists(gt_json), (
            f"Missing pseudo-label json {gt_json}; run "
            "tools/generate_pseudo_labels.py first."
        )
        with open(gt_json) as f:
            info = json.load(f)
        files = [
            (
                ann["file_name"].replace("label_", "image_"),
                os.path.join(gt_dir, ann["file_name"]),
                ann["segments_info"],
            )
            for ann in info["annotations"]
        ]

    calib_cache: Dict[str, Dict] = {}
    ret = []
    for rel_file, label_file, segments_info in files:
        image_file = os.path.join(root, "kitti_eigen", rel_file)
        prev_f, next_f = _neighbors(image_file)
        if is_train and not (os.path.exists(prev_f) and os.path.exists(next_f)):
            continue
        depth_file = _depth_file_for(image_file)
        if "test" in os.path.basename(gt_dir) and not os.path.exists(depth_file):
            continue
        # calibration lives four levels up (date folder)
        parent = os.path.abspath(os.path.join(image_file, "../../../.."))
        if parent not in calib_cache:
            calib_cache[parent] = read_kitti_calib(parent)
        K = _intrinsics_for(image_file, calib_cache[parent])
        calibration_info = dict(
            intrinsic=dict(
                fx=float(K[0, 0]), fy=float(K[1, 1]),
                u0=float(K[0, 2]), v0=float(K[1, 2]),
            ),
            extrinsic=dict(baseline=0.54, z=1.65),
        )
        ret.append(
            dict(
                file_name=image_file,
                image_id=os.path.splitext(rel_file)[0],
                pan_seg_file_name=label_file,
                depth_file_name=depth_file,
                prev_img_file_name=prev_f,
                next_img_file_name=next_f,
                segments_info=[convert_seg(s) for s in segments_info],
                calibration_info=calibration_info,
            )
        )
    assert ret, f"No images found from {image_split_file}"
    return ret


def register_all_kitti_eigen_scene_seg(root: str,
                                       pseudo_label_generation: bool = False):
    categories = (
        CITYSCAPES_SCENE_SEG_CATEGORIES if pseudo_label_generation
        else CITYSCAPES_CATEGORIES
    )
    meta = build_meta(categories)
    for key, (split_file, gt_dir, gt_json) in _SPLITS.items():
        split_file = os.path.join(root, split_file)
        gt_dir = os.path.join(root, gt_dir)
        gt_json = os.path.join(root, gt_json)

        def loader(split_file=split_file, gt_dir=gt_dir, gt_json=gt_json):
            return load_kitti_eigen_scene_seg(
                root, split_file, gt_dir, gt_json, meta,
                pseudo_label_generation=pseudo_label_generation,
            )

        DatasetCatalog.register(key, loader)
        MetadataCatalog.get(key).set(
            image_file_list=split_file,
            panoptic_root=gt_dir,
            panoptic_json=gt_json,
            gt_dir=os.path.dirname(gt_dir),
            evaluator_type="kitti_eigen_scene_seg",
            **meta,
        )
