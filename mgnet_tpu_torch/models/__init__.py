"""MGNet modules, NCHW inside."""

from mgnet_tpu_torch.models.mgnet import MGNet, build_model, init_random_

__all__ = ["MGNet", "build_model", "init_random_"]
