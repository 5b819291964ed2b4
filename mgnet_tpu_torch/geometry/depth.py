"""Inverse-depth helpers (port of ``mgnet_tpu/geometry/depth.py:17-62``):
``inv2depth`` and the edge-aware ``calc_smoothness``."""

from __future__ import annotations

import torch

from mgnet_tpu_torch.geometry.image import gradient_x, gradient_y

__all__ = ["calc_smoothness", "inv2depth"]


def inv2depth(inv_depth):
    """depth = 1 / max(inv_depth, 1e-6); lists map element-wise."""
    if isinstance(inv_depth, (tuple, list)):
        return [inv2depth(d) for d in inv_depth]
    return 1.0 / torch.clamp(inv_depth, min=1e-6)


def calc_smoothness(inv_depths, image: torch.Tensor, num_scales: int):
    """Image-gradient-weighted gradients of the mean-normalized inverse
    depths, per scale.

    Args:
        inv_depths: list of [B, H, W, 1] inverse depth maps.
        image: [B, H, W, 3] image at the same resolution.

    Returns:
        (smoothness_x list of [B,H,W-1,1], smoothness_y list of [B,H-1,W,1])
    """
    norm = [d / torch.clamp(d.mean(dim=(1, 2), keepdim=True), min=1e-6)
            for d in inv_depths]
    weights_x = torch.exp(-gradient_x(image).abs().mean(dim=-1,
                                                         keepdim=True))
    weights_y = torch.exp(-gradient_y(image).abs().mean(dim=-1,
                                                         keepdim=True))
    return ([gradient_x(norm[i]) * weights_x for i in range(num_scales)],
            [gradient_y(norm[i]) * weights_y for i in range(num_scales)])
