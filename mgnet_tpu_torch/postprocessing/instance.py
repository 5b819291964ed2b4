"""Instance extraction from a panoptic prediction (evaluation only).

A copy of ``mgnet_tpu/postprocessing/instance.py:19-59`` (numpy).

Behavioral parity with reference: mgnet/postprocessing/instance_post_proc.py
(per thing segment: mask, score = mean semantic probability over the mask x
center-heatmap probability at the mask centroid, bounding box from the
mask). The reference returns detectron2 ``Instances``; here we return plain
numpy dicts — this path is host-side eval glue, not compute.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["extract_instances"]


def extract_instances(
    sem_seg_probs: np.ndarray,
    center_heatmap: np.ndarray,
    panoptic: np.ndarray,
    thing_ids: Sequence[int],
    label_divisor: int = 1000,
) -> List[Dict]:
    """Args:
        sem_seg_probs: [H, W, C] softmax semantic probabilities.
        center_heatmap: [H, W] center scores.
        panoptic: [H, W] panoptic ids.

    Returns:
        list of dicts with keys: pred_class, score, mask [H, W] bool,
        bbox (x0, y0, x1, y1).
    """
    thing_ids = set(int(t) for t in thing_ids)
    out: List[Dict] = []
    for pan_id in np.unique(panoptic):
        if pan_id < 0:
            continue
        pred_class = int(pan_id) // label_divisor
        if pred_class not in thing_ids:
            continue
        mask = panoptic == pan_id
        ys, xs = np.nonzero(mask)
        if ys.size == 0:
            continue
        sem_score = float(sem_seg_probs[..., pred_class][mask].mean())
        cy, cx = int(ys.mean()), int(xs.mean())
        center_score = float(center_heatmap[cy, cx])
        bbox = (int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max()))
        out.append(
            dict(
                pred_class=pred_class,
                score=sem_score * center_score,
                mask=mask,
                bbox=bbox,
            )
        )
    return out
