"""Instance segmentation AP evaluation — cityscapesscripts protocol.

A copy of ``mgnet_tpu/evaluation/instance_ap.py`` (numpy), gathering
across processes through ``mgnet_tpu_torch.parallel``.

The reference enables detectron2's CityscapesInstanceEvaluator (driving
cityscapesscripts' evalInstanceLevelSemanticLabeling) behind
TEST.EVAL_INSTANCE (reference: tools/train_net.py:65-66). That protocol
differs from COCO AP in ways that change the numbers, so it is
reproduced natively here:

* Overlaps 0.50:0.05:0.95 (AP) and 0.50 (AP50), averaged per class then
  over classes.
* Matching per ground-truth instance: every prediction whose IoU with
  the gt exceeds the overlap counts — the highest-confidence one as the
  TP, every additional one as an FP at its (lower) confidence
  ("duplicate match" rule). A gt with no match is a *hard false
  negative* added to the FN count at every operating point.
* FP excusal: an unmatched prediction is NOT counted as FP if more than
  the overlap fraction of its pixels lies on ignore regions — void
  pixels (gt semantic = ignore), crowd regions of the same class, or gt
  instances below the minimum region size (100 px for Cityscapes).
* PR curve evaluated at the distinct confidence thresholds with
  TP/FP/FN counted from the sorted score list (hard FNs included), the
  curve closed with (recall 0, precision 1), and AP taken as
  dot(precision, centered recall step widths) — the cityscapesscripts
  convolution [-0.5, 0, 0.5].
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional

import numpy as np

from mgnet_tpu_torch.parallel.multihost import (
    all_gather_objects,
    process_count,
)

__all__ = ["InstanceAPEvaluator", "mask_iou"]

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    if inter == 0:
        return 0.0
    union = a.sum() + b.sum() - inter
    return float(inter / union)


class InstanceAPEvaluator:
    def __init__(self, metadata, min_region_size: int = 100):
        self.meta = metadata
        self.min_region_size = min_region_size
        self.thing_ids = sorted(
            metadata.thing_dataset_id_to_contiguous_id.values()
        )
        self.class_names = {
            c["trainId"]: c["name"] for c in metadata.categories
            if c["isthing"]
        }
        self.reset()

    def reset(self):
        # per class: list of per-image records
        #   {"gts": [{"size", "inters": {pred_idx: inter}}],
        #    "preds": [{"score", "size", "ignore_inter",
        #               "inters": {gt_idx: inter}}]}
        self._images: Dict[int, List[dict]] = defaultdict(list)

    def process(self, pred_instances: List[Dict],
                gt_instances: List[Dict],
                void_mask: Optional[np.ndarray] = None):
        """Accumulate one image.

        Args:
            pred_instances: dicts with pred_class / score / mask (bool).
            gt_instances: dicts with category_id (train id) / mask /
                optional iscrowd. Crowd entries are not matchable but
                excuse overlapping false positives of the same class.
            void_mask: optional [H, W] bool of ignore-label pixels
                (gt semantic not in eval classes); predictions mostly on
                void are excused.
        """
        preds_by_class: Dict[int, List[Dict]] = defaultdict(list)
        for p in pred_instances:
            preds_by_class[int(p["pred_class"])].append(p)
        gt_by_class: Dict[int, List[Dict]] = defaultdict(list)
        for g in gt_instances:
            gt_by_class[int(g["category_id"])].append(g)

        for cid in set(preds_by_class) | set(gt_by_class):
            if cid not in self.class_names:
                continue
            gts = gt_by_class.get(cid, [])
            preds = preds_by_class.get(cid, [])
            real_gts = [
                g for g in gts
                if not g.get("iscrowd", 0)
                and g["mask"].sum() >= self.min_region_size
            ]
            # ignore areas for the FP-excusal rule: void + same-class
            # crowd + same-class too-small gt instances
            ignore_masks = [g["mask"] for g in gts if g.get("iscrowd", 0)]
            ignore_masks += [
                g["mask"] for g in gts
                if not g.get("iscrowd", 0)
                and g["mask"].sum() < self.min_region_size
            ]
            if void_mask is not None:
                ignore_masks.append(void_mask)

            rec = {"gts": [], "preds": []}
            for g in real_gts:
                rec["gts"].append(
                    {"size": int(g["mask"].sum()), "inters": {}}
                )
            for pi, p in enumerate(preds):
                pm = p["mask"]
                psize = int(pm.sum())
                if psize == 0:
                    continue
                ignore_inter = 0
                if ignore_masks:
                    union_ignore = np.zeros_like(pm)
                    for m in ignore_masks:
                        union_ignore |= m
                    ignore_inter = int(
                        np.logical_and(pm, union_ignore).sum())
                entry = {"score": float(p["score"]), "size": psize,
                         "ignore_inter": ignore_inter, "inters": {}}
                for gi, g in enumerate(real_gts):
                    inter = int(np.logical_and(pm, g["mask"]).sum())
                    if inter > 0:
                        entry["inters"][gi] = inter
                        rec["gts"][gi]["inters"][len(rec["preds"])] = inter
                rec["preds"].append(entry)
            self._images[cid].append(rec)

    def _gather(self):
        """Merge accumulation state across processes."""
        if process_count() == 1:
            return
        states = all_gather_objects(dict(self._images))
        self.reset()
        for st in states:
            for cid, recs in st.items():
                self._images[cid].extend(recs)

    def _ap_for(self, cid: int, overlap: float) -> float:
        """cityscapesscripts evaluateMatches for one class + overlap."""
        y_true: List[float] = []
        y_score: List[float] = []
        hard_fns = 0
        n_gt = 0
        have_pred = False
        for rec in self._images.get(cid, []):
            preds = rec["preds"]
            have_pred = have_pred or bool(preds)
            n_gt += len(rec["gts"])
            for gt in rec["gts"]:
                found, best = False, -np.inf
                dups: List[float] = []
                for pi, inter in gt["inters"].items():
                    union = gt["size"] + preds[pi]["size"] - inter
                    if inter / union > overlap:
                        conf = preds[pi]["score"]
                        if found:
                            # duplicate match: lower score becomes FP
                            lo, hi = min(best, conf), max(best, conf)
                            best = hi
                            dups.append(lo)
                        else:
                            found, best = True, conf
                if found:
                    y_true.append(1.0)
                    y_score.append(best)
                    for s in dups:
                        y_true.append(0.0)
                        y_score.append(s)
                else:
                    hard_fns += 1
            # unmatched predictions -> FP unless mostly on ignore regions
            for pi, p in enumerate(preds):
                matched = any(
                    inter / (gt["size"] + p["size"] - inter) > overlap
                    for gt in rec["gts"]
                    for pj, inter in gt["inters"].items() if pj == pi
                )
                if matched:
                    continue
                if p["ignore_inter"] / p["size"] <= overlap:
                    y_true.append(0.0)
                    y_score.append(p["score"])

        if n_gt == 0:
            return float("nan")
        if not y_true and hard_fns == 0:
            return float("nan")

        y_true_a = np.asarray(y_true)
        y_score_a = np.asarray(y_score)
        order = np.argsort(y_score_a)
        y_score_s = y_score_a[order]
        y_true_s = y_true_a[order]
        cumsum = np.cumsum(y_true_s)
        n_examples = len(y_score_s)
        n_true = cumsum[-1] if n_examples else 0.0

        _, unique_idx = np.unique(y_score_s, return_index=True)
        n_points = len(unique_idx) + 1
        precision = np.zeros(n_points)
        recall = np.zeros(n_points)
        for res_i, score_i in enumerate(unique_idx):
            below = cumsum[score_i - 1] if score_i > 0 else 0.0
            tp = n_true - below
            fp = n_examples - score_i - tp
            fn = below + hard_fns
            precision[res_i] = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall[res_i] = tp / (tp + fn) if tp + fn > 0 else 0.0
        precision[-1] = 1.0
        recall[-1] = 0.0

        # cityscapesscripts AP: dot(precision, centered recall steps)
        recall_conv = np.append(recall[0], recall)
        recall_conv = np.append(recall_conv, 0.0)
        step_widths = np.convolve(recall_conv, [-0.5, 0, 0.5], "valid")
        return float(np.dot(precision, step_widths))

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        self._gather()
        per_class_ap, per_class_ap50 = {}, {}
        for cid in self.thing_ids:
            n_gt = sum(len(r["gts"]) for r in self._images.get(cid, []))
            if n_gt == 0:
                continue
            aps = [self._ap_for(cid, t) for t in IOU_THRESHOLDS]
            per_class_ap[cid] = float(np.nanmean(aps))
            per_class_ap50[cid] = self._ap_for(cid, 0.5)
        res = OrderedDict()
        if per_class_ap:
            res["AP"] = 100 * float(np.mean(list(per_class_ap.values())))
            res["AP50"] = 100 * float(np.mean(list(per_class_ap50.values())))
            for cid, ap in per_class_ap.items():
                res[f"AP-{self.class_names.get(cid, cid)}"] = 100 * ap
        else:
            res["AP"] = 0.0
            res["AP50"] = 0.0
        return OrderedDict({"instances": res})
