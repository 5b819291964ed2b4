"""Configuration of the port: the keys the inference frame and the training
step read.

A plain nested attribute tree with the defaults of
``mgnet_tpu/config.py::get_default_config`` (its lines 182-346), with no
YAML loading: that comes with a later slice. ``apply_cityscapes_fine``
applies the overrides of ``configs/MGNet-Cityscapes-Fine.yaml``, written
as Python values.

The JAX package's TPU-only switches (``MODEL.DEPTH_HEAD.USE_PALLAS_SSIM``,
``USE_PALLAS_WARP``, ``PALLAS_WARP_FAST``, ``POST_PROCESSING.
USE_PALLAS_FUSION``) have no counterpart: the port always runs its kernels
on the card, and its warp is the exact f32 gather.
"""

from __future__ import annotations

from types import SimpleNamespace

__all__ = ["Node", "apply_cityscapes_fine", "get_default_config"]


class Node(SimpleNamespace):
    """Attribute-access config node."""


def _decoder_head(num_classes=None) -> Node:
    h = Node(
        COMMON_STRIDE=8,
        ARM_CHANNELS=[128, 128],
        REFINE_CHANNELS=[128, 128],
        FFM_CHANNELS=256,
        HEAD_CHANNELS=256,
    )
    if num_classes is not None:
        h.NUM_CLASSES = num_classes
    return h


def get_default_config() -> Node:
    sem = _decoder_head(num_classes=20)
    sem.IGNORE_VALUE = 255
    sem.LOSS_WEIGHT = 1.0
    sem.LOSS_TYPE = "ohem"
    sem.LOSS_TOP_K = 0.2
    sem.OHEM_THRESHOLD = 0.7
    sem.OHEM_N_MIN = 100000
    ins = _decoder_head()
    ins.CENTER_LOSS_WEIGHT = 200.0
    ins.OFFSET_LOSS_WEIGHT = 0.01
    dep = _decoder_head()
    dep.MSC_LOSS = True
    dep.SSIM_LOSS_WEIGHT = 0.85
    dep.PHOTOMETRIC_LOSS_WEIGHT = 1.0
    dep.SMOOTHING_LOSS_WEIGHT = 0.001
    dep.AUTOMASK_LOSS = True
    dep.PHOTOMETRIC_REDUCE_OP = "min"
    dep.PADDING_MODE = "zeros"
    return Node(
        WITH_PANOPTIC=True,
        WITH_DEPTH=True,
        WITH_UNCERTAINTY=True,
        MODEL=Node(
            PIXEL_MEAN=[123.675, 116.280, 103.530],
            PIXEL_STD=[58.395, 57.120, 57.375],
            # conv stack dtype: "bfloat16" (autocast) or "float32"
            COMPUTE_DTYPE="bfloat16",
            RESNETS=Node(DEPTH=18),
            GCM=Node(GCM_CHANNELS=128),
            SEM_SEG_HEAD=sem,
            INS_EMBED_HEAD=ins,
            DEPTH_HEAD=dep,
            POST_PROCESSING=Node(
                STUFF_AREA=2048,
                CENTER_THRESHOLD=0.3,
                NMS_KERNEL=7,
                MAX_INSTANCES=128,
            ),
        ),
        SOLVER=Node(
            OPTIMIZER="ADAM",
            BASE_LR=0.0001,
            MAX_ITER=60000,
            IMS_PER_BATCH=12,
            GRAD_ACCUM_STEPS=1,
            LR_SCHEDULER_NAME="WarmupPolyLR",
            POLY_LR_POWER=0.9,
            POLY_LR_CONSTANT_ENDING=0.0,
            WARMUP_FACTOR=0.1,
            WARMUP_ITERS=1000,
            HEAD_LR_FACTOR=10.0,
            WEIGHT_DECAY=0.0,
            WEIGHT_DECAY_NORM=0.0,
            WEIGHT_DECAY_BIAS=0.0,
            CLIP_GRADIENTS=Node(
                ENABLED=True,
                CLIP_TYPE="full_model",
                CLIP_VALUE=0.01,
                NORM_TYPE=2.0,
            ),
        ),
        INPUT=Node(
            CROP=Node(SIZE=(1024, 1024)),
            IGNORED_CATEGORIES_IN_DEPTH=[],
        ),
    )


def apply_cityscapes_fine(cfg: Node) -> Node:
    """The overrides of configs/MGNet-Cityscapes-Fine.yaml (the flagship
    joint panoptic + depth recipe), in place; returns ``cfg``."""
    m = cfg.MODEL
    m.COMPUTE_DTYPE = "bfloat16"
    m.RESNETS.DEPTH = 18
    m.SEM_SEG_HEAD.COMMON_STRIDE = 8
    m.SEM_SEG_HEAD.HEAD_CHANNELS = 256
    m.SEM_SEG_HEAD.NUM_CLASSES = 20
    m.SEM_SEG_HEAD.LOSS_TYPE = "ohem"
    m.SEM_SEG_HEAD.OHEM_THRESHOLD = 0.7
    m.SEM_SEG_HEAD.OHEM_N_MIN = 262143  # (1024 * 1024 / 4) - 1
    m.INS_EMBED_HEAD.HEAD_CHANNELS = 256
    m.INS_EMBED_HEAD.CENTER_LOSS_WEIGHT = 200.0
    m.INS_EMBED_HEAD.OFFSET_LOSS_WEIGHT = 0.01
    s = cfg.SOLVER
    s.WEIGHT_DECAY = 0.0
    s.WEIGHT_DECAY_NORM = 0.0
    s.WEIGHT_DECAY_BIAS = 0.0
    s.BASE_LR = 0.0001
    s.MAX_ITER = 60000
    s.IMS_PER_BATCH = 12
    s.CLIP_GRADIENTS.ENABLED = True
    s.CLIP_GRADIENTS.CLIP_TYPE = "full_model"
    s.CLIP_GRADIENTS.CLIP_VALUE = 0.01
    s.CLIP_GRADIENTS.NORM_TYPE = 2.0
    cfg.INPUT.CROP.SIZE = (1024, 1024)
    cfg.INPUT.IGNORED_CATEGORIES_IN_DEPTH = ["ego vehicle", "sky"]
    return cfg
