"""Utilities: the weight bridge from the JAX package's flat arrays."""

from mgnet_tpu_torch.utils.weights import load_jax_params

__all__ = ["load_jax_params"]
