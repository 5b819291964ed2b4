"""Training losses: segmentation, instance embedding and photometric."""

from mgnet_tpu_torch.losses.photometric import (
    multi_view_photometric_loss,
    ssim,
)
from mgnet_tpu_torch.losses.segmentation import (
    center_loss,
    cross_entropy_loss,
    deeplab_ce_loss,
    offset_loss,
    ohem_ce_loss,
    topk_sum,
)

__all__ = ["center_loss", "cross_entropy_loss", "deeplab_ce_loss",
           "multi_view_photometric_loss", "offset_loss", "ohem_ce_loss",
           "ssim", "topk_sum"]
