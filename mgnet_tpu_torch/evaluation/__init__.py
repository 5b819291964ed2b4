"""Evaluation (numpy): panoptic quality, semantic IoU and iIoU, depth
errors and the cityscapesscripts instance AP; the public names of
``mgnet_tpu/evaluation/__init__.py`` plus the instance AP."""

from mgnet_tpu_torch.evaluation.depth import (
    DepthEvaluator,
    depth_metrics,
    read_depth_gt,
)
from mgnet_tpu_torch.evaluation.instance_ap import (
    InstanceAPEvaluator,
    mask_iou,
)
from mgnet_tpu_torch.evaluation.panoptic import PanopticEvaluator
from mgnet_tpu_torch.evaluation.pq import (
    PQStat,
    pq_compute_single_image,
    summarize_pq,
)
from mgnet_tpu_torch.evaluation.semantic import SemSegEvaluator

__all__ = [
    "DepthEvaluator",
    "depth_metrics",
    "read_depth_gt",
    "InstanceAPEvaluator",
    "mask_iou",
    "PanopticEvaluator",
    "SemSegEvaluator",
    "PQStat",
    "pq_compute_single_image",
    "summarize_pq",
]
