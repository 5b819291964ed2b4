"""Post-processing: panoptic fusion and the DGC depth scale."""

from mgnet_tpu_torch.postprocessing.depth import (
    dgc_scale_factor,
    surface_normals,
)
from mgnet_tpu_torch.postprocessing.panoptic import (
    find_instance_centers,
    panoptic_fusion,
)

__all__ = ["dgc_scale_factor", "surface_normals", "find_instance_centers",
           "panoptic_fusion"]
