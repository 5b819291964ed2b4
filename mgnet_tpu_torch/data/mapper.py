"""Dataset mappers: per-image dict -> fixed-shape numpy training sample.

A copy of ``mgnet_tpu/data/mapper.py`` (the same output keys, dtypes and
use of the ``np.random.Generator``):
* shared geometric transforms applied to all 3 frames + the panoptic label;
* color jitter applied separately, keeping ``*_orig`` un-jittered copies
  for the photometric loss;
* panoptic targets via rgb2id + the target generator;
* reprojection mask: ignored semantic classes (ego/sky) and padded regions
  zeroed;
* camera-matrix co-augmentation: optical center via apply_coords, focal
  lengths via apply_focal; camera_height passthrough.

Images decode through ``image_io.read_png`` and stay uint8 [H, W, 3]; the
training step casts them on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from mgnet_tpu_torch.data import image_io
from mgnet_tpu_torch.data.catalog import MetadataCatalog
from mgnet_tpu_torch.data.decode_cache import build_decode_cache
from mgnet_tpu_torch.data.target_generator import PanopticTargetGenerator
from mgnet_tpu_torch.data.transforms import (
    ResizeTransform,
    build_train_transform_sampler,
    sample_color_jitter,
)

__all__ = ["TrainDatasetMapper", "TestDatasetMapper", "id2rgb", "rgb2id",
           "read_image"]


def rgb2id(color: np.ndarray) -> np.ndarray:
    """COCO-panoptic RGB encoding -> id: R + 256*G + 256^2*B."""
    color = color.astype(np.int64)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def id2rgb(ids: np.ndarray) -> np.ndarray:
    out = np.zeros(ids.shape + (3,), np.uint8)
    out[..., 0] = ids % 256
    out[..., 1] = (ids // 256) % 256
    out[..., 2] = (ids // (256 * 256)) % 256
    return out


def read_image(path: str) -> np.ndarray:
    """Read an RGB uint8 image (a PNG; see ``image_io.read_png``)."""
    return image_io.read_png(path)


def _camera_matrix_from_calib(calib: Dict) -> np.ndarray:
    intr = calib["intrinsic"]
    return np.array(
        [[intr["fx"], 0, intr["u0"]],
         [0, intr["fy"], intr["v0"]],
         [0, 0, 1]], np.float32,
    )


class TrainDatasetMapper:
    """Callable: dataset dict -> training sample dict of numpy arrays."""

    def __init__(self, cfg, dataset_name: Optional[str] = None):
        self.cfg = cfg
        self.with_depth = cfg.WITH_DEPTH
        self.with_panoptic = cfg.WITH_PANOPTIC
        self._cache = build_decode_cache(cfg)
        self.sampler = build_train_transform_sampler(cfg)
        self.color_jitter_enabled = cfg.INPUT.COLOR_JITTER.ENABLED
        dataset_name = dataset_name or cfg.DATASETS.TRAIN[0]
        meta = MetadataCatalog.get(dataset_name)
        self.meta = meta
        thing_ids = list(
            meta.thing_dataset_id_to_contiguous_id.values()
        )
        self.target_gen = PanopticTargetGenerator(
            ignore_label=meta.ignore_label,
            thing_ids=thing_ids,
            sigma=cfg.INPUT.GAUSSIAN_SIGMA,
            ignore_stuff_in_offset=cfg.INPUT.IGNORE_STUFF_IN_OFFSET,
            small_instance_area=cfg.INPUT.SMALL_INSTANCE_AREA,
            small_instance_weight=cfg.INPUT.SMALL_INSTANCE_WEIGHT,
            ignore_crowd_in_semantic=cfg.INPUT.IGNORE_CROWD_IN_SEMANTIC,
        )
        self.depth_ignore_ids: List[int] = []
        if self.with_depth:
            for cat in meta.categories:
                if cat["name"] in cfg.INPUT.IGNORED_CATEGORIES_IN_DEPTH:
                    self.depth_ignore_ids.append(cat["trainId"])

    def _read(self, path: str) -> np.ndarray:
        if self._cache is not None:
            return self._cache.get(path)
        return read_image(path)

    def __call__(self, dataset_dict: Dict,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng()
        d = dict(dataset_dict)
        image_orig = self._read(d["file_name"])
        pan_rgb = self._read(d["pan_seg_file_name"])

        tfl = self.sampler(rng, image_orig.shape)
        image_orig = tfl.apply_image(image_orig)
        pan_rgb = tfl.apply_segmentation(pan_rgb)

        jitter = None
        if self.color_jitter_enabled:
            cj = self.cfg.INPUT.COLOR_JITTER
            jitter = sample_color_jitter(
                rng, cj.BRIGHTNESS, cj.CONTRAST, cj.SATURATION, cj.HUE
            )
            image = jitter.apply_image(image_orig)
        else:
            image = image_orig

        # images stay uint8: the device casts (train/step.py unit_image /
        # normalize_images) — 4x less H2D and no full-res host f32 passes
        out: Dict[str, np.ndarray] = {"image": image}

        pan_ids = rgb2id(pan_rgb)
        targets = self.target_gen(pan_ids, d["segments_info"])
        center_pts = targets.pop("center_points")
        out.update({k: np.asarray(v) for k, v in targets.items()})
        out["center"] = out["center"][..., None]  # [H, W, 1]

        if self.with_depth:
            prev_orig = tfl.apply_image(self._read(d["prev_img_file_name"]))
            next_orig = tfl.apply_image(self._read(d["next_img_file_name"]))
            if jitter is not None:
                prev = jitter.apply_image(prev_orig)
                nxt = jitter.apply_image(next_orig)
            else:
                prev, nxt = prev_orig, next_orig
            out["image_prev"] = prev
            out["image_next"] = nxt
            out["image_orig"] = image_orig
            out["image_prev_orig"] = prev_orig
            out["image_next_orig"] = next_orig

            # reprojection mask: drop ignored classes, then let transforms
            # that define apply_reprojection_mask (pad) zero their borders
            # (reference dataset_mapper.py:210-213,234-244)
            mask = np.ones_like(pan_ids, dtype=bool)
            for tid in self.depth_ignore_ids:
                mask[out["sem_seg"] == tid] = False
            mask = tfl.apply_reprojection_mask(mask)
            out["reprojection_mask"] = mask[..., None].astype(np.float32)

            # camera matrix co-augmentation
            calib = d["calibration_info"]
            oc = np.array(
                [[calib["intrinsic"]["u0"], calib["intrinsic"]["v0"]]],
                np.float64,
            )
            fl = np.array(
                [[calib["intrinsic"]["fx"], calib["intrinsic"]["fy"]]],
                np.float64,
            )
            oc = tfl.apply_coords(oc)
            fl = tfl.apply_focal(fl)
            out["camera_matrix"] = np.array(
                [[fl[0, 0], 0, oc[0, 0]],
                 [0, fl[0, 1], oc[0, 1]],
                 [0, 0, 1]], np.float32,
            )
            out["camera_height"] = np.float32(calib["extrinsic"]["z"])

        out["image_id"] = d.get("image_id", "")
        return out


class TestDatasetMapper:
    """Resize-only test mapper (reference dataset_mapper.py:262-307)."""

    def __init__(self, cfg, dataset_name: Optional[str] = None):
        self.cfg = cfg
        self.min_size = cfg.INPUT.MIN_SIZE_TEST
        self.max_size = cfg.INPUT.MAX_SIZE_TEST
        self._cache = build_decode_cache(cfg)

    def _resize(self, h: int, w: int) -> ResizeTransform:
        size = self.min_size
        if size == 0:
            return ResizeTransform(h, w, h, w)
        scale = size / min(h, w)
        newh, neww = (size, scale * w) if h < w else (scale * h, size)
        if max(newh, neww) > self.max_size:
            s = self.max_size / max(newh, neww)
            newh, neww = newh * s, neww * s
        return ResizeTransform(h, w, int(newh + 0.5), int(neww + 0.5))

    def __call__(self, dataset_dict: Dict) -> Dict:
        d = dict(dataset_dict)
        if self._cache is not None:
            image = self._cache.get(d["file_name"])
        else:
            image = read_image(d["file_name"])
        h, w = image.shape[:2]
        t = self._resize(h, w)
        out = {
            "image": t.apply_image(image).astype(np.float32),
            "height": h,
            "width": w,
            "image_id": d.get("image_id", ""),
        }
        if "calibration_info" in d:
            out["camera_matrix"] = _camera_matrix_from_calib(
                d["calibration_info"]
            )
            out["camera_height"] = np.float32(
                d["calibration_info"]["extrinsic"]["z"]
            )
        for k in ("pan_seg_file_name", "sem_seg_file_name",
                  "disparity_file_name", "depth_file_name", "segments_info",
                  "calibration_info", "file_name"):
            if k in d:
                out.setdefault("meta", {})[k] = d[k]
        return out
