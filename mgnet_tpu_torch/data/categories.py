"""Category tables for Cityscapes scene segmentation.

A copy of ``mgnet_tpu/data/categories.py``: the 19 Cityscapes eval classes
plus the 'ego vehicle' class prepended with trainId 0 (shifting all others
by +1) for the 20-class scene-seg variant. Data (ids/colors/names) is the
public Cityscapes label definition.
"""

from __future__ import annotations

import copy
from typing import Dict, List

__all__ = [
    "CITYSCAPES_CATEGORIES",
    "CITYSCAPES_SCENE_SEG_CATEGORIES",
    "CITYSCAPES_SUPERCATEGORY",
    "build_meta",
]


def _cat(color, isthing, cid, train_id, ignore_in_eval, name) -> Dict:
    return {
        "color": color, "isthing": isthing, "id": cid, "trainId": train_id,
        "ignoreInEval": ignore_in_eval, "name": name,
    }


# Public Cityscapes 19-class eval set (labels from cityscapesscripts).
CITYSCAPES_CATEGORIES: List[Dict] = [
    _cat((128, 64, 128), 0, 7, 0, False, "road"),
    _cat((244, 35, 232), 0, 8, 1, False, "sidewalk"),
    _cat((70, 70, 70), 0, 11, 2, False, "building"),
    _cat((102, 102, 156), 0, 12, 3, False, "wall"),
    _cat((190, 153, 153), 0, 13, 4, False, "fence"),
    _cat((153, 153, 153), 0, 17, 5, False, "pole"),
    _cat((250, 170, 30), 0, 19, 6, False, "traffic light"),
    _cat((220, 220, 0), 0, 20, 7, False, "traffic sign"),
    _cat((107, 142, 35), 0, 21, 8, False, "vegetation"),
    _cat((152, 251, 152), 0, 22, 9, False, "terrain"),
    _cat((70, 130, 180), 0, 23, 10, False, "sky"),
    _cat((220, 20, 60), 1, 24, 11, False, "person"),
    _cat((255, 0, 0), 1, 25, 12, False, "rider"),
    _cat((0, 0, 142), 1, 26, 13, False, "car"),
    _cat((0, 0, 70), 1, 27, 14, False, "truck"),
    _cat((0, 60, 100), 1, 28, 15, False, "bus"),
    _cat((0, 80, 100), 1, 31, 16, False, "train"),
    _cat((0, 0, 230), 1, 32, 17, False, "motorcycle"),
    _cat((119, 11, 32), 1, 33, 18, False, "bicycle"),
]

# Scene-seg variant: ego vehicle becomes a trainable class with trainId 0.
CITYSCAPES_SCENE_SEG_CATEGORIES: List[Dict] = [
    _cat((72, 209, 204), 0, 1, 0, True, "ego vehicle"),
]
for _c in copy.deepcopy(CITYSCAPES_CATEGORIES):
    _c["trainId"] += 1
    CITYSCAPES_SCENE_SEG_CATEGORIES.append(_c)


# Public Cityscapes label -> supercategory mapping (labels_cityscapes), as
# mgnet_tpu/evaluation/semantic.py holds it
CITYSCAPES_SUPERCATEGORY = {
    "road": "flat", "sidewalk": "flat", "parking": "flat",
    "rail track": "flat",
    "building": "construction", "wall": "construction",
    "fence": "construction", "guard rail": "construction",
    "bridge": "construction", "tunnel": "construction",
    "pole": "object", "polegroup": "object", "traffic light": "object",
    "traffic sign": "object",
    "vegetation": "nature", "terrain": "nature",
    "sky": "sky",
    "person": "human", "rider": "human",
    "car": "vehicle", "truck": "vehicle", "bus": "vehicle",
    "caravan": "vehicle", "trailer": "vehicle", "train": "vehicle",
    "motorcycle": "vehicle", "bicycle": "vehicle",
    "ego vehicle": "vehicle", "license plate": "vehicle",
}


def build_meta(categories: List[Dict]) -> Dict:
    """Build the metadata dict shared by all registries."""
    thing_map, stuff_map = {}, {}
    for k in categories:
        (thing_map if k["isthing"] else stuff_map)[k["id"]] = k["trainId"]
    return dict(
        categories=categories,
        thing_classes=[k["name"] for k in categories],
        thing_colors=[k["color"] for k in categories],
        stuff_classes=[k["name"] for k in categories],
        stuff_colors=[k["color"] for k in categories],
        ignore_in_eval=[
            {"id": k["id"], "trainId": k["trainId"]}
            for k in categories if k["ignoreInEval"]
        ],
        thing_dataset_id_to_contiguous_id=thing_map,
        stuff_dataset_id_to_contiguous_id=stuff_map,
        ignore_label=255,
        label_divisor=1000,
    )
