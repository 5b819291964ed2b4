"""Carry weights from the JAX package's flat 'path/leaf' arrays into the
port's modules.

The JAX package flattens its params and batch_stats trees to keys such as
``backbone/res3_block0/conv1/conv/kernel`` (``mgnet_tpu/utils/weights.py``
``flatten_params``; ``weights/imagenet_weights.npz`` holds the same keys).
The port names its modules after that tree, so a key maps by rule:

* ``/`` -> ``.``; the ``BatchNorm_0`` level is folded into ``ABN``;
* ``kernel`` [kh, kw, in, out] (HWIO) -> ``weight`` [out, in, kh, kw] (OIHW);
* ``scale``, ``bias``, ``mean``, ``var`` -> ``weight``, ``bias``,
  ``running_mean``, ``running_var``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_params", "torch_key"]

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def torch_key(jax_key: str) -> str:
    parts = [p for p in jax_key.split("/") if p != "BatchNorm_0"]
    leaf = parts[-1]
    if leaf not in _LEAF:
        raise KeyError(f"{jax_key}: unknown leaf '{leaf}'")
    return ".".join(parts[:-1] + [_LEAF[leaf]])


def load_jax_params(flat: Mapping[str, np.ndarray],
                    module: nn.Module) -> Dict[str, torch.Tensor]:
    """Map flat JAX arrays onto ``module``'s state_dict keys.

    Returns a complete state_dict for ``module`` (pass it to
    ``module.load_state_dict``). Raises if a key has no home in the module,
    if a shape disagrees, or if any entry of the module's state_dict is left
    unset. To fill one submodule, pass the keys below its prefix with the
    prefix removed, and the submodule.
    """
    target = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    homeless, bad_shape = [], []
    for key, value in flat.items():
        tk = torch_key(key)
        if tk not in target:
            homeless.append(key)
            continue
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        if key.endswith("/kernel"):
            t = t.permute(3, 2, 0, 1)
        if tuple(t.shape) != tuple(target[tk].shape):
            bad_shape.append(f"{key} {tuple(t.shape)} vs "
                             f"{tuple(target[tk].shape)}")
            continue
        out[tk] = t.contiguous().to(target[tk].device)
    unset = sorted(set(target) - set(out))
    if homeless or bad_shape or unset:
        raise ValueError(
            "load_jax_params: "
            f"{len(homeless)} keys without a home {homeless[:5]}, "
            f"{len(bad_shape)} shape mismatches {bad_shape[:5]}, "
            f"{len(unset)} module entries unset {unset[:5]}")
    return out
