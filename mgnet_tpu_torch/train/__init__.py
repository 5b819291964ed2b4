"""Training-side helpers the inference slice needs."""

from mgnet_tpu_torch.train.step import normalize_images

__all__ = ["normalize_images"]
