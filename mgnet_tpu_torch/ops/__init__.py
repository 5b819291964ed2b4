"""Hand-written CUDA kernels of the port, with their plain versions."""

from mgnet_tpu_torch.ops.center_argmin import (
    center_argmin,
    center_argmin_reference,
    center_inputs,
)
from mgnet_tpu_torch.ops.ssim import (
    fused_photometric_residual,
    ssim_residual_bwd,
    ssim_residual_bwd_reference,
    ssim_residual_fwd,
    ssim_residual_reference,
)
from mgnet_tpu_torch.ops.warp import warp_bilinear, warp_bilinear_reference

__all__ = ["center_argmin", "center_argmin_reference", "center_inputs",
           "fused_photometric_residual", "ssim_residual_bwd",
           "ssim_residual_bwd_reference", "ssim_residual_fwd",
           "ssim_residual_reference", "warp_bilinear",
           "warp_bilinear_reference"]
