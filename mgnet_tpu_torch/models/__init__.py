"""MGNet modules, NCHW inside."""

from mgnet_tpu_torch.models.mgnet import (
    MGNet,
    as_float64_,
    build_model,
    init_random_,
)

__all__ = ["MGNet", "as_float64_", "build_model", "init_random_"]
