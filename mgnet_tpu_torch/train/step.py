"""Input normalization (port of ``normalize_images``,
``mgnet_tpu/train/step.py:38-46``; the training step comes later)."""

from __future__ import annotations

import torch

__all__ = ["normalize_images"]


def normalize_images(images: torch.Tensor, pixel_mean,
                     pixel_std) -> torch.Tensor:
    """uint8/float [B,H,W,3] -> normalized float32:
    /255, then (x - mean/255) / (std/255)."""
    x = images.float() / 255.0
    mean = torch.as_tensor(pixel_mean, dtype=torch.float32,
                           device=x.device) / 255.0
    std = torch.as_tensor(pixel_std, dtype=torch.float32,
                          device=x.device) / 255.0
    return (x - mean) / std
