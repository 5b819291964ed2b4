"""Convert torchvision ResNet-18/34 weights to the npz the port grafts.

    python -m mgnet_tpu_torch.tools.convert_torchvision_weights
        --backbone swsl_resnet18.pth [--pose resnet18.pth] [--depth 18]
        --output weights/imagenet_weights.npz

The counterpart of ``tools/convert_torchvision_weights.py``: a torchvision
ResNet state_dict becomes flat ``path/leaf`` arrays in the JAX package's
layout (HWIO kernels), which ``utils.weights.load_pretrained_npz`` (the
Trainer's ``MODEL.WEIGHTS``) reads. The ``--backbone`` weights go under
``backbone/``, the ``--pose`` weights under ``pose_net/encoder/`` with the
stem's kernel tiled 3x over the 9 channels of the three-frame concat and
divided by 3. The ``.pth`` is read with ``torch.load(weights_only=True)``
(a state_dict of plain tensors, or one under ``"state_dict"``); torchvision
itself is not needed. The conversion runs on the host.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

__all__ = ["convert_resnet", "load_state_dict", "main"]

STAGE_BLOCKS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3]}


def _to_hwio(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def convert_resnet(state_dict: Mapping[str, np.ndarray], prefix: str,
                   depth: int = 18,
                   expand_in_channels: int = 0) -> Dict[str, np.ndarray]:
    """A torchvision ResNet state_dict (numpy arrays) -> flat keys under
    ``prefix`` (``backbone`` or ``pose_net/encoder``). With
    ``expand_in_channels`` the stem kernel is tiled to that many input
    channels and divided by the number of copies."""
    out = {}

    def put_conv(dst, w):
        out[f"{prefix}/{dst}/conv/kernel"] = _to_hwio(w)

    def put_bn(dst, src):
        for leaf, name in (("scale", "weight"), ("bias", "bias"),
                           ("mean", "running_mean"), ("var", "running_var")):
            out[f"{prefix}/{dst}/abn/BatchNorm_0/{leaf}"] = \
                state_dict[f"{src}.{name}"]

    stem_w = state_dict["conv1.weight"]
    if expand_in_channels:
        reps = expand_in_channels // stem_w.shape[1]
        stem_w = np.concatenate([stem_w] * reps, axis=1) / reps
    put_conv("stem/conv1", stem_w)
    put_bn("stem/conv1", "bn1")

    for stage_idx, n_blocks in enumerate(STAGE_BLOCKS[depth]):
        for b in range(n_blocks):
            src = f"layer{stage_idx + 1}.{b}"
            dst = f"res{stage_idx + 2}_block{b}"
            put_conv(f"{dst}/conv1", state_dict[f"{src}.conv1.weight"])
            put_bn(f"{dst}/conv1", f"{src}.bn1")
            put_conv(f"{dst}/conv2", state_dict[f"{src}.conv2.weight"])
            put_bn(f"{dst}/conv2", f"{src}.bn2")
            if f"{src}.downsample.0.weight" in state_dict:
                put_conv(f"{dst}/shortcut",
                         state_dict[f"{src}.downsample.0.weight"])
                put_bn(f"{dst}/shortcut", f"{src}.downsample.1")
    return out


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The tensors of a ``.pth`` state_dict as numpy arrays."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.numpy() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backbone", required=True,
                   help="torchvision ResNet .pth for the main backbone")
    p.add_argument("--pose", default="",
                   help="torchvision ResNet .pth for the pose encoder")
    p.add_argument("--depth", type=int, default=18)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    flat = convert_resnet(load_state_dict(args.backbone), "backbone",
                          args.depth)
    if args.pose:
        flat.update(convert_resnet(
            load_state_dict(args.pose), "pose_net/encoder", args.depth,
            expand_in_channels=9))
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    np.savez(args.output, **flat)
    print(f"Wrote {len(flat)} arrays to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
