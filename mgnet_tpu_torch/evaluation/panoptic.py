"""Panoptic Quality evaluator (numpy).

A copy of ``mgnet_tpu/evaluation/panoptic.py``, gathering across
processes through ``mgnet_tpu_torch.parallel``. Behavioral parity with
reference: mgnet/evaluation/panoptic_evaluation.py —
assign ignore_in_eval categories (ego vehicle) to VOID in both prediction
and GT; build segments_info from the raw panoptic id map
(category * label_divisor + instance); compute PQ/SQ/RQ for All / Things /
Stuff. The reference round-trips predictions through PNG files and
panopticapi; here the accumulation runs directly on arrays with the native
PQ implementation (evaluation/pq.py), and the PNG writer remains available
for artifact export.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from mgnet_tpu_torch.evaluation.pq import (
    PQStat,
    pq_compute_single_image,
    summarize_pq,
)
from mgnet_tpu_torch.parallel.multihost import (
    all_gather_objects,
    process_count,
)

__all__ = ["PanopticEvaluator"]


class PanopticEvaluator:
    def __init__(self, metadata, output_dir: Optional[str] = None):
        """metadata: a data.catalog.Metadata with categories /
        label_divisor / ignore_in_eval / panoptic gt locations."""
        self.meta = metadata
        self.label_divisor = metadata.label_divisor
        self.ignored_train_ids = [
            c["trainId"] for c in metadata.ignore_in_eval
        ]
        self.thing_train_ids = set(
            metadata.thing_dataset_id_to_contiguous_id.values()
        )
        # categories keyed by *train id* (predictions and our GT id maps
        # both use train ids)
        self.categories = {
            c["trainId"]: {"id": c["trainId"], "isthing": c["isthing"],
                           "name": c["name"]}
            for c in metadata.categories
            if not c["ignoreInEval"]
        }
        self.output_dir = output_dir
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
        self.reset()

    def reset(self):
        self.stat = PQStat()
        self.n_images = 0

    @staticmethod
    def _segments_from_map(pan: np.ndarray, label_divisor: int) -> List[dict]:
        segs = []
        for pid in np.unique(pan):
            if pid <= 0:
                continue
            segs.append({
                "id": int(pid),
                "category_id": int(pid) // label_divisor,
            })
        return segs

    def _to_eval_map(self, pan: np.ndarray) -> np.ndarray:
        """Shift ids so VOID==0 and drop ignored categories."""
        pan = pan.astype(np.int64).copy()
        for tid in self.ignored_train_ids:
            pan[pan // self.label_divisor == tid] = -1
        return pan + 1  # VOID(-1) -> 0

    def process(self, pred_panoptic: np.ndarray, gt_panoptic: np.ndarray,
                gt_segments: Optional[List[dict]] = None):
        """Accumulate one image.

        Args:
            pred_panoptic: [H, W] predicted ids
                (class_trainId * divisor + instance, -1 void).
            gt_panoptic: [H, W] GT ids. When ``gt_segments`` is None, the
                same train-id encoding as predictions; otherwise raw
                COCO-panoptic ids (rgb2id of the gt PNG) matched to
                ``gt_segments`` entries by 'id' (category_id already
                remapped to train ids by the dataset registry).
            gt_segments: optional segments_info with id / category_id
                (train id) / iscrowd.
        """
        pred = self._to_eval_map(pred_panoptic)
        pred_segs = [
            {"id": s["id"] + 1, "category_id": s["category_id"]}
            for s in self._segments_from_map(pred_panoptic, self.label_divisor)
        ]
        if gt_segments is None:
            gt = self._to_eval_map(gt_panoptic)
            gt_segs = [
                {"id": s["id"] + 1, "category_id": s["category_id"],
                 "iscrowd": 0}
                for s in self._segments_from_map(gt_panoptic, self.label_divisor)
            ]
        else:
            # raw COCO ids: void ignored-category segments (reference
            # filters them from the gt json, panoptic_evaluation.py:139-145)
            gt = gt_panoptic.astype(np.int64).copy()
            gt_segs = []
            for s in gt_segments:
                if s["category_id"] in self.ignored_train_ids:
                    gt[gt == s["id"]] = 0
                    continue
                gt_segs.append({
                    "id": s["id"], "category_id": s["category_id"],
                    "iscrowd": s.get("iscrowd", 0),
                })
        self.stat += pq_compute_single_image(
            gt, pred, gt_segs, pred_segs, self.categories
        )
        self.n_images += 1

    def _gather(self):
        """Merge accumulation state across processes (reference
        comm.synchronize + gather, panoptic_evaluation.py:119-122)."""
        if process_count() == 1:
            return
        states = all_gather_objects((dict(self.stat.stats), self.n_images))
        merged = PQStat()
        self.n_images = 0
        for stats, n in states:
            other = PQStat()
            other.stats.update(stats)
            merged += other
            self.n_images += n
        self.stat = merged

    def evaluate(self, print_table: bool = True
                 ) -> Dict[str, Dict[str, float]]:
        self._gather()
        pq_res = summarize_pq(self.stat, self.categories)
        res = {
            "PQ": 100 * pq_res["All"]["pq"],
            "SQ": 100 * pq_res["All"]["sq"],
            "RQ": 100 * pq_res["All"]["rq"],
            "PQ_th": 100 * pq_res["Things"]["pq"],
            "SQ_th": 100 * pq_res["Things"]["sq"],
            "RQ_th": 100 * pq_res["Things"]["rq"],
            "PQ_st": 100 * pq_res["Stuff"]["pq"],
            "SQ_st": 100 * pq_res["Stuff"]["sq"],
            "RQ_st": 100 * pq_res["Stuff"]["rq"],
        }
        if print_table:
            print(self.format_table(pq_res))
        return OrderedDict({"panoptic_seg": res})

    def format_table(self, pq_res=None) -> str:
        """All/Things/Stuff + per-class PQ table (reference
        _print_panoptic_results, panoptic_evaluation.py:183-197)."""
        if pq_res is None:
            pq_res = summarize_pq(self.stat, self.categories)
        lines = [
            "| {:>13s} | {:>7s} | {:>7s} | {:>7s} | {:>4s} |".format(
                "", "PQ", "SQ", "RQ", "#cat"),
            "|" + "-" * 53 + "|",
        ]
        for name in ("All", "Things", "Stuff"):
            r = pq_res[name]
            lines.append(
                "| {:>13s} | {:7.3f} | {:7.3f} | {:7.3f} | {:4d} |".format(
                    name, 100 * r["pq"], 100 * r["sq"], 100 * r["rq"],
                    r["n"])
            )
        per_class = pq_res["All"].get("per_class") or {}
        for cid, r in sorted(per_class.items()):
            name = self.categories[cid]["name"][:13]
            lines.append(
                "| {:>13s} | {:7.3f} | {:7.3f} | {:7.3f} |      |".format(
                    name, 100 * r["pq"], 100 * r["sq"], 100 * r["rq"])
            )
        return "\n".join(lines)
