"""Inverse-depth helpers (port of ``mgnet_tpu/geometry/depth.py:17-25``)."""

from __future__ import annotations

import torch

__all__ = ["inv2depth"]


def inv2depth(inv_depth):
    """depth = 1 / max(inv_depth, 1e-6); lists map element-wise."""
    if isinstance(inv_depth, (tuple, list)):
        return [inv2depth(d) for d in inv_depth]
    return 1.0 / torch.clamp(inv_depth, min=1e-6)
