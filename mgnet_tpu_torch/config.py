"""Default configuration of the port: the keys the inference slice reads.

A plain nested attribute tree with the defaults of
``mgnet_tpu/config.py::get_default_config`` (its lines 182-298 and the
INPUT key), with no YAML loading: that comes with a later slice.
"""

from __future__ import annotations

from types import SimpleNamespace

__all__ = ["Node", "get_default_config"]


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
    return Node(
        MODEL=Node(
            PIXEL_MEAN=[123.675, 116.280, 103.530],
            PIXEL_STD=[58.395, 57.120, 57.375],
            # conv stack dtype: "bfloat16" (autocast) or "float32"
            COMPUTE_DTYPE="bfloat16",
            RESNETS=Node(DEPTH=18),
            GCM=Node(GCM_CHANNELS=128),
            SEM_SEG_HEAD=_decoder_head(num_classes=20),
            POST_PROCESSING=Node(
                STUFF_AREA=2048,
                CENTER_THRESHOLD=0.3,
                NMS_KERNEL=7,
                MAX_INSTANCES=128,
            ),
        ),
        INPUT=Node(IGNORED_CATEGORIES_IN_DEPTH=[]),
    )
