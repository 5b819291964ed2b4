"""Depth evaluation (numpy).

A copy of ``mgnet_tpu/evaluation/depth.py``: the ground truth is read by
the port's ``read_png`` (16-bit grey as uint16) in place of Pillow, and
the gather across processes goes through ``mgnet_tpu_torch.parallel``.
Behavioral parity with reference: mgnet/evaluation/depth_evaluation.py —
GT from KITTI depth PNG (/256) or Cityscapes disparity ((v-1)/256 ->
depth via baseline*fx/disp); validity mask (min_depth, max_depth); optional
Eigen crop; optional GT-median scaling when DGC is off; metrics AbsRel /
SqRel / RMSE / RMSElog / delta<1.25^{1,2,3}; per-image accumulation then
mean.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import numpy as np

from mgnet_tpu_torch.data.image_io import read_png
from mgnet_tpu_torch.parallel.multihost import (
    all_gather_objects,
    process_count,
)

__all__ = ["DepthEvaluator", "depth_metrics", "read_depth_gt"]


def read_depth_gt(sample_meta: Dict) -> np.ndarray:
    """Load metric depth GT for one sample from its dataset dict."""
    if sample_meta.get("depth_file_name"):
        return read_png(sample_meta["depth_file_name"]).astype(
            np.float32) / 256.0
    if sample_meta.get("disparity_file_name"):
        label = read_png(sample_meta["disparity_file_name"]).astype(
            np.float32)
        nz = label != 0
        label[nz] = (label[nz] - 1.0) / 256.0  # stored disparity encoding
        calib = sample_meta["calibration_info"]
        factor = calib["extrinsic"]["baseline"] * calib["intrinsic"]["fx"]
        label[nz] = factor / label[nz]
        return label
    raise RuntimeError(
        "Neither depth_file_name nor disparity_file_name available — "
        "cannot evaluate depth."
    )


def depth_metrics(pred: np.ndarray, label: np.ndarray) -> List[float]:
    """[abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3] over valid pixels."""
    thresh = np.maximum(label / pred, pred / label)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25**2).mean())
    a3 = float((thresh < 1.25**3).mean())
    rmse = float(np.sqrt(((label - pred) ** 2).mean()))
    rmse_log = float(np.sqrt(((np.log(label) - np.log(pred)) ** 2).mean()))
    abs_rel = float(np.mean(np.abs(label - pred) / label))
    sq_rel = float(np.mean((label - pred) ** 2 / label))
    return [abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3]


class DepthEvaluator:
    def __init__(self, min_depth: float = 0.001, max_depth: float = 80.0,
                 use_gt_scale: bool = False, use_eigen_crop: bool = False):
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.use_gt_scale = use_gt_scale
        self.use_eigen_crop = use_eigen_crop
        self.reset()

    def reset(self):
        self._errors: List[List[float]] = []
        self._ratios: List[float] = []

    def process(self, depth_pred: np.ndarray, sample_meta: Dict):
        """depth_pred: [H, W] metric depth at original resolution."""
        label = read_depth_gt(sample_meta)
        mask = (label > self.min_depth) & (label < self.max_depth)
        if self.use_eigen_crop:
            h, w = label.shape[-2:]
            crop = np.array(
                [0.40810811 * h, 0.99189189 * h,
                 0.03594771 * w, 0.96405229 * w]
            ).astype(np.int32)
            crop_mask = np.zeros_like(mask)
            crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = True
            mask &= crop_mask

        pred = np.asarray(depth_pred)[mask]
        gt = label[mask]
        if self.use_gt_scale:
            ratio = float(np.median(gt) / np.median(pred))
            self._ratios.append(ratio)
            pred = pred * ratio
        pred = np.clip(pred, self.min_depth, self.max_depth)
        self._errors.append(depth_metrics(pred, gt))

    def _gather(self):
        """Merge per-image accumulations across processes (reference
        comm gather, depth_evaluation.py:114-124)."""
        if process_count() == 1:
            return
        states = all_gather_objects((self._errors, self._ratios))
        self._errors, self._ratios = [], []
        for errors, ratios in states:
            self._errors.extend(errors)
            self._ratios.extend(ratios)

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        self._gather()
        if not self._errors:
            return {"depth": {}}
        mean = np.asarray(self._errors).mean(0)
        ret = OrderedDict()
        ret["depth"] = {
            "Abs Rel": float(mean[0]),
            "Sq Rel": float(mean[1]),
            "RMSE": float(mean[2]),
            "RMSE log": float(mean[3]),
            "δ < 1.25": float(mean[4]),
            "δ < 1.25²": float(mean[5]),
            "δ < 1.25³": float(mean[6]),
        }
        if self.use_gt_scale and self._ratios:
            ratios = np.asarray(self._ratios)
            med = float(np.median(ratios))
            ret["depth"]["scale_ratio_median"] = med
            ret["depth"]["scale_ratio_std"] = float(np.std(ratios / med))
        return ret
