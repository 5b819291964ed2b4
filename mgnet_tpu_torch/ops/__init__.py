"""Hand-written CUDA kernels of the port, with their plain versions."""

from mgnet_tpu_torch.ops.center_argmin import (
    center_argmin,
    center_argmin_reference,
    center_inputs,
)

__all__ = ["center_argmin", "center_argmin_reference", "center_inputs"]
