"""Synthetic training batch made from a seed (numpy, host side).

A copy of ``mgnet_tpu/data/synthetic.py::synthetic_train_batch`` for the
joint model (both task branches always): random
images with context frames shifted by +-2 columns, a plausible pinhole
camera, a full reprojection mask, and panoptic targets of two thing
instances on one stuff class per image. The real data mapper is a later
slice of the port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from mgnet_tpu_torch.data.target_generator import PanopticTargetGenerator

__all__ = ["synthetic_train_batch"]


def synthetic_train_batch(
    batch: int = 2,
    height: int = 64,
    width: int = 64,
    num_classes: int = 20,
    last_stuff_id: int = 10,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Random scene with two instances per image + plausible camera."""
    rng = np.random.RandomState(seed)
    out: Dict[str, np.ndarray] = {}

    def rand_img():
        return rng.randint(0, 255, (batch, height, width, 3)).astype(
            np.float32)

    out["image"] = rand_img()
    out["image_prev"] = np.roll(out["image"], 2, axis=2)
    out["image_next"] = np.roll(out["image"], -2, axis=2)
    out["image_orig"] = out["image"] / 255.0
    out["image_prev_orig"] = out["image_prev"] / 255.0
    out["image_next_orig"] = out["image_next"] / 255.0
    K = np.array(
        [[0.8 * width, 0, (width - 1) / 2],
         [0, 0.8 * width, (height - 1) / 2],
         [0, 0, 1]], np.float32,
    )
    out["camera_matrix"] = np.broadcast_to(K, (batch, 3, 3)).copy()
    out["reprojection_mask"] = np.ones((batch, height, width, 1), np.float32)
    out["camera_height"] = np.full((batch,), 1.65, np.float32)

    thing_ids = list(range(last_stuff_id + 1, num_classes))
    gen = PanopticTargetGenerator(
        ignore_label=255, thing_ids=thing_ids, sigma=8,
        small_instance_area=64, small_instance_weight=3,
    )
    keys = ("sem_seg", "center", "offset", "sem_seg_weights",
            "center_weights", "offset_weights")
    acc = {k: [] for k in keys}
    for _ in range(batch):
        pan = np.full((height, width), 1 * 1000, np.int32)
        segs = [dict(id=1000, category_id=1, iscrowd=0)]
        for i, cid in enumerate(rng.choice(thing_ids, 2)):
            y0 = rng.randint(0, height // 2)
            x0 = rng.randint(0, width // 2)
            pid = cid * 1000 + i + 1
            pan[y0:y0 + height // 3, x0:x0 + width // 3] = pid
            segs.append(dict(id=pid, category_id=int(cid), iscrowd=0))
        t = gen(pan, segs)
        t["center"] = t["center"][..., None]
        for k in keys:
            acc[k].append(t[k])
    out.update({k: np.stack(v) for k, v in acc.items()})
    return out
