"""Native Panoptic Quality computation (numpy).

A copy of ``mgnet_tpu/evaluation/pq.py``. The reference delegates PQ to
the external ``panopticapi`` package (reference:
mgnet/evaluation/panoptic_evaluation.py:157-165). That package
is not part of this framework's dependency set, so PQ is implemented here
from the published definition (Kirillov et al., "Panoptic Segmentation"):

    PQ = sum_{TP} IoU / (|TP| + 0.5 |FP| + 0.5 |FN|),  SQ = IoU/|TP|,
    RQ = |TP| / (|TP| + 0.5 |FP| + 0.5 |FN|)

with the standard matching rules: segments match when IoU > 0.5 (unique by
the theorem), crowd GT segments don't participate in matching, the void
region is subtracted from the union, and unmatched predictions that are
mostly void/crowd-of-same-class are excused from FP.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

__all__ = ["PQStat", "pq_compute_single_image", "summarize_pq"]

VOID = 0
_OFFSET = 256 * 256 * 256


class PQStat:
    """Per-category TP/FP/FN/IoU accumulators."""

    def __init__(self):
        self.stats: Dict[int, Dict[str, float]] = defaultdict(
            lambda: {"iou": 0.0, "tp": 0, "fp": 0, "fn": 0}
        )

    def __iadd__(self, other: "PQStat") -> "PQStat":
        for cat, s in other.stats.items():
            mine = self.stats[cat]
            for k in mine:
                mine[k] += s[k]
        return self

    def accumulate(self, cat_id: int, *, iou: float = 0.0, tp: int = 0,
                   fp: int = 0, fn: int = 0):
        s = self.stats[cat_id]
        s["iou"] += iou
        s["tp"] += tp
        s["fp"] += fp
        s["fn"] += fn


def pq_compute_single_image(
    pan_gt: np.ndarray,
    pan_pred: np.ndarray,
    gt_segments: List[dict],
    pred_segments: List[dict],
    categories: Dict[int, dict],
) -> PQStat:
    """Accumulate PQ statistics for one image.

    Args:
        pan_gt / pan_pred: [H, W] int id maps, 0 (VOID) = unlabeled.
        gt_segments / pred_segments: dicts with id / category_id /
            (gt only) iscrowd.
        categories: {category_id: {...}} — segments with ids outside this
            dict are ignored (treated as void-ish).
    """
    stat = PQStat()
    gt_by_id = {s["id"]: s for s in gt_segments}
    pred_by_id = {s["id"]: s for s in pred_segments}

    # areas from the maps (robust to stale 'area' fields)
    gt_ids, gt_areas = np.unique(pan_gt, return_counts=True)
    pred_ids, pred_areas = np.unique(pan_pred, return_counts=True)
    gt_area = dict(zip(gt_ids.tolist(), gt_areas.tolist()))
    pred_area = dict(zip(pred_ids.tolist(), pred_areas.tolist()))

    # joint intersections
    combined = pan_gt.astype(np.uint64) * _OFFSET + pan_pred.astype(np.uint64)
    pairs, inters = np.unique(combined, return_counts=True)
    inter = {
        (int(p // _OFFSET), int(p % _OFFSET)): int(c)
        for p, c in zip(pairs.tolist(), inters.tolist())
    }

    matched_gt, matched_pred = set(), set()
    for (gid, pid), i in inter.items():
        if gid not in gt_by_id or pid not in pred_by_id:
            continue
        g, p = gt_by_id[gid], pred_by_id[pid]
        if g.get("iscrowd", 0) == 1:
            continue
        if g["category_id"] != p["category_id"]:
            continue
        if g["category_id"] not in categories:
            continue
        void_inter = inter.get((VOID, pid), 0)
        union = (gt_area.get(gid, 0) + pred_area.get(pid, 0) - i - void_inter)
        if union <= 0:
            continue
        iou = i / union
        if iou > 0.5:
            stat.accumulate(g["category_id"], iou=iou, tp=1)
            matched_gt.add(gid)
            matched_pred.add(pid)

    # false negatives (non-crowd, known category, unmatched)
    crowd_by_cat: Dict[int, int] = {}
    for gid, g in gt_by_id.items():
        if g["category_id"] not in categories:
            continue
        if g.get("iscrowd", 0) == 1:
            crowd_by_cat[g["category_id"]] = gid
            continue
        if gid not in matched_gt and gt_area.get(gid, 0) > 0:
            stat.accumulate(g["category_id"], fn=1)

    # false positives (unless mostly void/crowd-of-same-class)
    for pid, p in pred_by_id.items():
        if pid in matched_pred:
            continue
        if p["category_id"] not in categories:
            continue
        area = pred_area.get(pid, 0)
        if area == 0:
            continue
        excuse = inter.get((VOID, pid), 0)
        crowd_gid = crowd_by_cat.get(p["category_id"])
        if crowd_gid is not None:
            excuse += inter.get((crowd_gid, pid), 0)
        if excuse / area <= 0.5:
            stat.accumulate(p["category_id"], fp=1)
    return stat


def summarize_pq(stat: PQStat, categories: Dict[int, dict]) -> Dict[str, dict]:
    """Aggregate into All / Things / Stuff {pq, sq, rq, n} (fractions)."""
    out = {}
    for name, filt in (
        ("All", lambda c: True),
        ("Things", lambda c: bool(c["isthing"])),
        ("Stuff", lambda c: not c["isthing"]),
    ):
        n, pq, sq, rq = 0, 0.0, 0.0, 0.0
        per_class = {}
        for cid, cat in categories.items():
            if not filt(cat):
                continue
            s = stat.stats.get(cid, {"iou": 0.0, "tp": 0, "fp": 0, "fn": 0})
            if s["tp"] + s["fp"] + s["fn"] == 0:
                # panopticapi semantics: categories with no TP/FP/FN
                # anywhere in the split are excluded from the mean
                continue
            denom = s["tp"] + 0.5 * s["fp"] + 0.5 * s["fn"]
            cat_pq = s["iou"] / denom if denom > 0 else 0.0
            cat_sq = s["iou"] / s["tp"] if s["tp"] > 0 else 0.0
            cat_rq = s["tp"] / denom if denom > 0 else 0.0
            per_class[cid] = {"pq": cat_pq, "sq": cat_sq, "rq": cat_rq}
            pq += cat_pq
            sq += cat_sq
            rq += cat_rq
            n += 1
        out[name] = {
            "pq": pq / n if n else 0.0,
            "sq": sq / n if n else 0.0,
            "rq": rq / n if n else 0.0,
            "n": n,
            "per_class": per_class if name == "All" else None,
        }
    return out
