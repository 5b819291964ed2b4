"""Dataset metadata, panoptic targets and the synthetic training batch."""

from mgnet_tpu_torch.data.catalog import Metadata
from mgnet_tpu_torch.data.categories import (
    CITYSCAPES_CATEGORIES,
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    build_meta,
)
from mgnet_tpu_torch.data.synthetic import synthetic_train_batch
from mgnet_tpu_torch.data.target_generator import PanopticTargetGenerator

__all__ = ["Metadata", "CITYSCAPES_CATEGORIES",
           "CITYSCAPES_SCENE_SEG_CATEGORIES", "PanopticTargetGenerator",
           "build_meta", "synthetic_train_batch"]
