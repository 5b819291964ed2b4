"""Utilities: checkpoints, metric logging, dotted-path loading, peak
memory and timing, and the weight bridge from the JAX package's flat
arrays."""

from mgnet_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    load_params,
    save_params,
)
from mgnet_tpu_torch.utils.events import MetricLogger
from mgnet_tpu_torch.utils.loader import locate
from mgnet_tpu_torch.utils.profiling import peak_hbm_gb, steady_state_timer
from mgnet_tpu_torch.utils.weights import load_jax_params, load_pretrained_npz

__all__ = ["CheckpointManager", "MetricLogger", "load_jax_params",
           "load_params", "load_pretrained_npz", "locate", "peak_hbm_gb",
           "save_params", "steady_state_timer"]
