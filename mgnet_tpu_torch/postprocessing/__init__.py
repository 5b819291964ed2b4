"""Post-processing: panoptic fusion, the DGC depth scale and rescale, and
the instances of a panoptic map."""

from mgnet_tpu_torch.postprocessing.depth import (
    depth_postprocess,
    dgc_scale_factor,
    surface_normals,
)
from mgnet_tpu_torch.postprocessing.instance import extract_instances
from mgnet_tpu_torch.postprocessing.panoptic import (
    find_instance_centers,
    panoptic_fusion,
)

__all__ = ["depth_postprocess", "dgc_scale_factor", "extract_instances",
           "surface_normals", "find_instance_centers", "panoptic_fusion"]
