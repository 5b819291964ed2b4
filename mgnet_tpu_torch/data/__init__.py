"""Data pipeline: dataset registries, PNG decode, Pillow-exact transforms,
the mappers, the threaded loader, panoptic targets and the synthetic
training batch (the public names of ``mgnet_tpu/data/__init__.py``, plus
the port's own)."""

from mgnet_tpu_torch.data.catalog import (
    DatasetCatalog,
    Metadata,
    MetadataCatalog,
)
from mgnet_tpu_torch.data.categories import (
    CITYSCAPES_CATEGORIES,
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    build_meta,
)
from mgnet_tpu_torch.data.cityscapes import register_all_cityscapes_scene_seg
from mgnet_tpu_torch.data.image_io import read_png, write_png
from mgnet_tpu_torch.data.kitti import register_all_kitti_eigen_scene_seg
from mgnet_tpu_torch.data.loader import (
    TrainLoader,
    collate_batch,
    test_loader,
    to_device,
)
from mgnet_tpu_torch.data.mapper import (
    TestDatasetMapper,
    TrainDatasetMapper,
    id2rgb,
    read_image,
    rgb2id,
)
from mgnet_tpu_torch.data.synthetic import (
    make_synthetic_cityscapes_raw,
    make_synthetic_kitti_raw,
    synthetic_train_batch,
    write_cityscapes_tree,
)
from mgnet_tpu_torch.data.target_generator import PanopticTargetGenerator

__all__ = [
    "DatasetCatalog",
    "MetadataCatalog",
    "Metadata",
    "CITYSCAPES_CATEGORIES",
    "CITYSCAPES_SCENE_SEG_CATEGORIES",
    "build_meta",
    "register_all_cityscapes_scene_seg",
    "register_all_kitti_eigen_scene_seg",
    "TrainLoader",
    "test_loader",
    "collate_batch",
    "to_device",
    "TrainDatasetMapper",
    "TestDatasetMapper",
    "PanopticTargetGenerator",
    "rgb2id",
    "id2rgb",
    "read_image",
    "read_png",
    "write_png",
    "make_synthetic_cityscapes_raw",
    "make_synthetic_kitti_raw",
    "synthetic_train_batch",
    "write_cityscapes_tree",
]
