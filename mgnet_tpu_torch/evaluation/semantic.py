"""Semantic segmentation evaluation: IoU and instance-weighted iIoU.

A copy of ``mgnet_tpu/evaluation/semantic.py`` (numpy), with the
supercategory table from ``mgnet_tpu_torch.data.categories`` and the
gather across processes through ``mgnet_tpu_torch.parallel``.

Behavioral parity with reference: mgnet/evaluation/semantic_evaluation.py,
which shells out to cityscapesscripts' evalPixelLevelSemanticLabeling and
reports four averages — IoU over classes, iIoU over instance classes,
IoU_sup over supercategories, iIoU_sup over instance supercategories.

The cityscapesscripts semantics, reproduced natively:

* IoU per class = TP / (TP + FP + FN) from the pixel confusion matrix.
* iIoU per *instance* class = iTP / (iTP + FP + iFN): the TP/FN
  contributions of every ground-truth instance are re-weighted by
  (average instance size of that class) / (size of that instance), so
  small instances count as much as large ones; FP stays unweighted
  because predictions carry no instance information. Crowd regions are
  not individual instances and contribute only to the unweighted scores.
* Supercategory scores project train ids onto the seven Cityscapes
  categories (flat / construction / object / nature / sky / human /
  vehicle) before the same computation; instance supercategories are
  human and vehicle.

Average instance sizes default to the published cityscapesscripts
constants (``avgClassSize`` / ``avgCategorySize`` in
evalPixelLevelSemanticLabeling.py); pass ``avg_class_size`` to override.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from mgnet_tpu_torch.data.categories import CITYSCAPES_SUPERCATEGORY
from mgnet_tpu_torch.parallel.multihost import (
    all_gather_objects,
    process_count,
)

__all__ = ["SemSegEvaluator"]

# Public constants from cityscapesscripts evalPixelLevelSemanticLabeling:
# dataset-average instance sizes used for the iIoU weighting.
CITYSCAPES_AVG_CLASS_SIZE = {
    "bicycle": 4672.3249222261,
    "caravan": 36771.8241758242,
    "motorcycle": 6298.7200839748,
    "rider": 3930.4788056518,
    "bus": 35732.1511111111,
    "train": 67583.7075812274,
    "car": 12794.0202738185,
    "person": 3462.4756337644,
    "truck": 27855.1264367816,
    "trailer": 16926.9763313609,
}
CITYSCAPES_AVG_CATEGORY_SIZE = {
    "human": 3331.0620695691,
    "vehicle": 23521.2559548312,
}

INSTANCE_SUPERCATEGORIES = ("human", "vehicle")


class SemSegEvaluator:
    def __init__(self, metadata, ignore_label: int = 255,
                 avg_class_size: Optional[Dict[str, float]] = None,
                 avg_category_size: Optional[Dict[str, float]] = None):
        self.meta = metadata
        self.ignore_label = ignore_label
        self.class_names = {
            c["trainId"]: c["name"]
            for c in metadata.categories if not c["ignoreInEval"]
        }
        self.excluded = [
            c["trainId"] for c in metadata.categories if c["ignoreInEval"]
        ]
        self.instance_classes = {
            c["trainId"]: c["name"]
            for c in metadata.categories
            if c["isthing"] and not c["ignoreInEval"]
        }
        self.num_classes = len(metadata.categories)
        self.avg_class_size = dict(avg_class_size
                                   or CITYSCAPES_AVG_CLASS_SIZE)
        self.avg_category_size = dict(avg_category_size
                                      or CITYSCAPES_AVG_CATEGORY_SIZE)

        # supercategory projection: trainId -> category index
        sup_names: List[str] = []
        self._sup_of_class = np.full((self.num_classes,), -1, np.int64)
        self._sup_names = sup_names
        for c in metadata.categories:
            sup = CITYSCAPES_SUPERCATEGORY.get(c["name"])
            if sup is None or c["ignoreInEval"]:
                continue
            if sup not in sup_names:
                sup_names.append(sup)
            self._sup_of_class[c["trainId"]] = sup_names.index(sup)
        self.reset()

    def reset(self):
        n = self.num_classes
        self.confusion = np.zeros((n, n), np.int64)
        # per instance class / supercategory: [weighted TP, weighted FN]
        self._inst_stats = {
            tid: np.zeros(2) for tid in self.instance_classes
        }
        self._sup_inst_stats = {
            s: np.zeros(2) for s in INSTANCE_SUPERCATEGORIES
            if s in self._sup_names
        }

    def process(self, pred: np.ndarray, gt: np.ndarray,
                gt_instances: Optional[List[dict]] = None):
        """Accumulate one image.

        Args:
            pred/gt: [H, W] train ids; gt may contain ignore_label.
            gt_instances: optional instance masks for the iIoU weighting:
                list of {'category_id': trainId, 'mask': bool [H, W]}
                for each non-crowd thing instance (derived from the
                panoptic GT by the caller).
        """
        valid = gt != self.ignore_label
        for tid in self.excluded:
            valid &= gt != tid
        p = pred[valid].astype(np.int64)
        g = gt[valid].astype(np.int64)
        n = self.num_classes
        idx = g * n + np.clip(p, 0, n - 1)
        self.confusion += np.bincount(idx, minlength=n * n).reshape(n, n)

        if not gt_instances:
            return
        for inst in gt_instances:
            tid = int(inst["category_id"])
            if tid not in self._inst_stats:
                continue
            name = self.instance_classes[tid]
            mask = inst["mask"]
            size = float(mask.sum())
            if size == 0:
                continue
            tp_inst = float(np.count_nonzero(pred[mask] == tid))
            w = self.avg_class_size.get(name, size) / size
            self._inst_stats[tid] += (w * tp_inst, w * (size - tp_inst))

            sup = CITYSCAPES_SUPERCATEGORY.get(name)
            if sup in self._sup_inst_stats:
                # supercategory TP: prediction in ANY class of the same
                # supercategory counts (cityscapesscripts category eval)
                sup_idx = self._sup_names.index(sup)
                pred_sup = self._sup_of_class[
                    np.clip(pred[mask], 0, n - 1)]
                tp_sup = float(np.count_nonzero(pred_sup == sup_idx))
                ws = self.avg_category_size.get(sup, size) / size
                self._sup_inst_stats[sup] += (
                    ws * tp_sup, ws * (size - tp_sup))

    def _gather(self):
        """Merge accumulation state across processes (reference
        comm.synchronize in CityscapesEvaluator.evaluate)."""
        if process_count() == 1:
            return
        states = all_gather_objects(
            (self.confusion, self._inst_stats, self._sup_inst_stats)
        )
        self.reset()
        for conf, inst, sup in states:
            self.confusion += conf
            for k, v in inst.items():
                self._inst_stats[k] += v
            for k, v in sup.items():
                self._sup_inst_stats[k] += v

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        self._gather()
        tp = np.diag(self.confusion).astype(np.float64)
        fp = self.confusion.sum(0) - tp
        fn = self.confusion.sum(1) - tp
        denom = tp + fp + fn
        per_class = {}
        ious = []
        for tid, name in self.class_names.items():
            if denom[tid] > 0:
                iou = float(tp[tid] / denom[tid])
                per_class[f"IoU-{name}"] = 100 * iou
                ious.append(iou)

        # iIoU over instance classes: iTP / (iTP + FP + iFN)
        per_class_i = {}
        iious = []
        for tid, name in self.instance_classes.items():
            itp, ifn = self._inst_stats[tid]
            d = itp + ifn + fp[tid]
            if d > 0 or denom[tid] > 0:
                iiou = float(itp / d) if d > 0 else 0.0
                per_class_i[f"iIoU-{name}"] = 100 * iiou
                iious.append(iiou)

        # supercategory scores: project the confusion matrix
        n_sup = len(self._sup_names)
        sup_ious, sup_iious = [], []
        if n_sup:
            proj = np.zeros((self.num_classes, n_sup))
            for tid in range(self.num_classes):
                s = self._sup_of_class[tid]
                if s >= 0:
                    proj[tid, s] = 1.0
            conf_sup = proj.T @ self.confusion @ proj
            tps = np.diag(conf_sup)
            fps = conf_sup.sum(0) - tps
            fns = conf_sup.sum(1) - tps
            for si in range(n_sup):
                d = tps[si] + fps[si] + fns[si]
                if d > 0:
                    sup_ious.append(float(tps[si] / d))
            for sup, (itp, ifn) in self._sup_inst_stats.items():
                si = self._sup_names.index(sup)
                d = itp + ifn + fps[si]
                if d > 0:
                    sup_iious.append(float(itp / d))

        res = {
            "mIoU": 100 * float(np.mean(ious)) if ious else 0.0,
            "IoU": 100 * float(np.mean(ious)) if ious else 0.0,
            "iIoU": 100 * float(np.mean(iious)) if iious else 0.0,
            "IoU_sup": 100 * float(np.mean(sup_ious)) if sup_ious else 0.0,
            "iIoU_sup": (100 * float(np.mean(sup_iious))
                         if sup_iious else 0.0),
        }
        res.update(per_class)
        res.update(per_class_i)
        return OrderedDict({"sem_seg": res})
