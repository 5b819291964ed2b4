"""Panoptic training targets (host side, numpy).

A copy of ``mgnet_tpu/data/target_generator.py::PanopticTargetGenerator``
(the port imports nothing of the JAX package): per segment the semantic
map, the max-combined Gaussian center heatmap (sigma 8), the offsets to
the instance centroid, and the semantic / center / offset loss weights.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["PanopticTargetGenerator"]


class PanopticTargetGenerator:
    def __init__(
        self,
        ignore_label: int,
        thing_ids: Sequence[int],
        sigma: int = 8,
        ignore_stuff_in_offset: bool = True,
        small_instance_area: int = 4096,
        small_instance_weight: int = 3,
        ignore_crowd_in_semantic: bool = False,
    ):
        self.ignore_label = ignore_label
        self.thing_ids = sorted(int(t) for t in thing_ids)
        self.sigma = sigma
        self.ignore_stuff_in_offset = ignore_stuff_in_offset
        self.small_instance_area = small_instance_area
        self.small_instance_weight = small_instance_weight
        self.ignore_crowd_in_semantic = ignore_crowd_in_semantic

        # Precompute the Gaussian stamp once (reference :47-52).
        size = 6 * sigma + 3
        coords = np.arange(size, dtype=np.float64)
        mu = 3 * sigma + 1
        gx = np.exp(-((coords - mu) ** 2) / (2 * sigma**2))
        self._stamp = np.outer(gx, gx)

    def _paint_gaussian(self, heatmap: np.ndarray, cy: float, cx: float):
        """Max-combine the Gaussian stamp centered at (cy, cx)."""
        h, w = heatmap.shape
        sigma = self.sigma
        y, x = int(round(cy)), int(round(cx))
        x0, y0 = x - 3 * sigma - 1, y - 3 * sigma - 1
        x1, y1 = x + 3 * sigma + 2, y + 3 * sigma + 2
        sx0, sy0 = max(0, -x0), max(0, -y0)
        sx1, sy1 = min(x1, w) - x0, min(y1, h) - y0
        dx0, dy0 = max(0, x0), max(0, y0)
        dx1, dy1 = min(x1, w), min(y1, h)
        if dx1 <= dx0 or dy1 <= dy0:
            return
        region = heatmap[dy0:dy1, dx0:dx1]
        np.maximum(region, self._stamp[sy0:sy1, sx0:sx1], out=region)

    def __call__(self, panoptic: np.ndarray,
                 segments_info: List[Dict]) -> Dict[str, np.ndarray]:
        """Args:
            panoptic: [H, W] int panoptic ids (rgb2id-decoded).
            segments_info: list of dicts with id / category_id / iscrowd.

        Returns dict of numpy arrays:
            sem_seg [H,W] int32, center [H,W] f32, offset [H,W,2] f32
            (dy, dx), sem_seg_weights [H,W] f32, center_weights [H,W] f32,
            offset_weights [H,W] f32, center_points list.
        """
        h, w = panoptic.shape
        first_thing = self.thing_ids[0]

        sem = np.full((h, w), self.ignore_label, np.int32)
        center = np.zeros((h, w), np.float32)
        offset = np.zeros((h, w, 2), np.float32)
        sem_weights = np.ones((h, w), np.float32)
        center_weights = np.zeros((h, w), np.float32)
        offset_weights = np.zeros((h, w), np.float32)
        center_points: List[List[float]] = []

        grid_y, grid_x = np.mgrid[0:h, 0:w].astype(np.float32)

        for seg in segments_info:
            seg_mask = panoptic == seg["id"]
            cat_id = int(seg["category_id"])
            crowd = bool(seg.get("iscrowd", 0))
            if not (self.ignore_crowd_in_semantic and crowd):
                sem[seg_mask] = cat_id
            is_thing = cat_id in self.thing_ids
            if not crowd and (not self.ignore_stuff_in_offset or is_thing):
                center_weights[seg_mask] = 1.0
                offset_weights[seg_mask] = 1.0
            if is_thing and not crowd:
                ys, xs = np.nonzero(seg_mask)
                if ys.size == 0:
                    continue  # instance fully cropped out
                if ys.size < self.small_instance_area:
                    sem_weights[seg_mask] = self.small_instance_weight
                cy, cx = float(ys.mean()), float(xs.mean())
                center_points.append([cy, cx])
                self._paint_gaussian(center, cy, cx)
                offset[..., 0][seg_mask] = cy - grid_y[seg_mask]
                offset[..., 1][seg_mask] = cx - grid_x[seg_mask]

        # Stuff-below-first-thing trick (reference :147): supervise the
        # center heatmap toward 0 on stuff pixels.
        center_weights[sem < first_thing] = 1.0

        return dict(
            sem_seg=sem,
            center=center.astype(np.float32),
            center_points=center_points,
            offset=offset,
            sem_seg_weights=sem_weights,
            center_weights=center_weights,
            offset_weights=offset_weights,
        )
