"""Dataset metadata: Cityscapes categories and the metadata record."""

from mgnet_tpu_torch.data.catalog import Metadata
from mgnet_tpu_torch.data.categories import (
    CITYSCAPES_CATEGORIES,
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    build_meta,
)

__all__ = ["Metadata", "CITYSCAPES_CATEGORIES",
           "CITYSCAPES_SCENE_SEG_CATEGORIES", "build_meta"]
