"""Carry weights between the JAX package's flat 'path/leaf' arrays and the
port's modules, both ways.

The JAX package flattens its params and batch_stats trees to keys such as
``backbone/res3_block0/conv1/conv/kernel`` (``mgnet_tpu/utils/weights.py``
``flatten_params``; ``weights/imagenet_weights.npz`` holds the same keys).
The port names its modules after that tree, so a key maps by rule:

* ``/`` -> ``.``; the ``BatchNorm_0`` level is folded into ``ABN``;
* ``kernel`` [kh, kw, in, out] (HWIO) -> ``weight`` [out, in, kh, kw] (OIHW);
* ``scale``, ``bias``, ``mean``, ``var`` -> ``weight``, ``bias``,
  ``running_mean``, ``running_var``; a conv's ``bias`` stays ``bias``;
* the train state's ``log_vars`` [5] (the uncertainty weights, beside
  ``model/...``) is ``log_vars`` of ``train.state.TrainParams``.

``jax_key`` and ``to_jax_arrays`` go the other way, so that tests can hold
the port's parameters and gradients against the JAX package's, leaf by
leaf.

``load_pretrained_npz`` grafts an npz of such keys (the ImageNet init,
``weights/imagenet_weights.npz``) into a module wherever key and shape
match, as ``mgnet_tpu/utils/weights.py::load_pretrained_npz`` does.
``load_eval_weights`` loads what ``--eval-only`` and the ``Predictor`` are
given: a ``model_final`` directory or such an npz.
"""

from __future__ import annotations

from typing import Dict, Mapping

import os

import numpy as np
import torch
from torch import nn

from mgnet_tpu_torch.utils.checkpoint import load_params

__all__ = ["jax_key", "load_eval_weights", "load_jax_params",
           "load_pretrained_npz", "to_jax_arrays", "torch_key"]

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var",
         "log_vars": "log_vars"}
_ABN_LEAF = {"weight": "scale", "bias": "bias", "running_mean": "mean",
             "running_var": "var"}


def torch_key(jax_key: str) -> str:
    parts = [p for p in jax_key.split("/") if p != "BatchNorm_0"]
    leaf = parts[-1]
    if leaf not in _LEAF:
        raise KeyError(f"{jax_key}: unknown leaf '{leaf}'")
    return ".".join(parts[:-1] + [_LEAF[leaf]])


def jax_key(torch_name: str) -> str:
    """The flat JAX key of a port state_dict / named_parameters key."""
    parts = torch_name.split(".")
    leaf = parts[-1]
    if len(parts) > 1 and parts[-2] == "abn":
        if leaf not in _ABN_LEAF:
            raise KeyError(f"{torch_name}: unknown ABN leaf '{leaf}'")
        return "/".join(parts[:-1] + ["BatchNorm_0", _ABN_LEAF[leaf]])
    if leaf not in ("weight", "bias", "log_vars"):
        raise KeyError(f"{torch_name}: unknown leaf '{leaf}'")
    return "/".join(parts[:-1] + ["kernel" if leaf == "weight" else leaf])


def to_jax_arrays(named: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Port tensors by name (a state_dict, or parameter gradients by
    parameter name) -> flat JAX keys and layouts (conv weights OIHW ->
    HWIO), as float32 numpy arrays."""
    out = {}
    for name, t in named.items():
        a = t.detach().float().cpu().numpy()
        key = jax_key(name)
        if key.endswith("/kernel"):
            a = a.transpose(2, 3, 1, 0)
        out[key] = np.ascontiguousarray(a)
    return out


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


@torch.no_grad()
def load_pretrained_npz(npz_path: str, module: nn.Module) -> Dict[str, int]:
    """Copy the npz's arrays into ``module``'s parameters and buffers
    wherever the key and the shape (in the port's layout) match; the rest
    keep their values. The npz keys are rooted at the model
    (``backbone/...``); a ``TrainParams`` roots them under ``model/``, and
    both rootings are tried. Returns {"matched", "skipped"}, counted as the
    JAX function counts them."""
    target = module.state_dict()
    by_key = {jax_key(name): name for name in target}
    matched, skipped = 0, 0
    with np.load(npz_path) as data:
        for k in data.files:
            name = by_key.get(k, by_key.get("model/" + k))
            v = torch.from_numpy(np.asarray(data[k], np.float32))
            if k.endswith("/kernel") and v.ndim == 4:
                v = v.permute(3, 2, 0, 1)
            if name is None or tuple(v.shape) != tuple(target[name].shape):
                skipped += 1
                continue
            target[name].copy_(v)
            matched += 1
    return {"matched": matched, "skipped": skipped}


def load_eval_weights(model: torch.nn.Module, weights: str) -> None:
    """Load ``weights`` into an eval model: a ``model_final`` directory
    (``save_params``'s; every entry of the model must be there, with its
    shape; the training model's extra leaves, such as the pose net, are
    left out), or an npz of JAX-layout arrays grafted where name and shape
    match (the rest keep their values; zero matches raise)."""
    if not weights:
        raise ValueError("evaluation needs MODEL.WEIGHTS: a model_final "
                         "directory or an npz")
    if os.path.isdir(weights):
        src = {k[len("model."):] if k.startswith("model.") else k: v
               for k, v in load_params(weights).items()}
        dst = model.state_dict()
        bad = sorted(k for k, v in dst.items()
                     if k not in src or src[k].shape != v.shape)
        if bad:
            raise ValueError(
                f"MODEL.WEIGHTS={weights!r} lacks {len(bad)} entries of the "
                f"model or has them in another shape: {bad[:6]}")
        model.load_state_dict({k: src[k] for k in dst})
        return
    info = load_pretrained_npz(weights, model)
    if info["matched"] == 0:
        raise ValueError(f"MODEL.WEIGHTS={weights!r} matched zero "
                         f"parameter leaves ({info})")
