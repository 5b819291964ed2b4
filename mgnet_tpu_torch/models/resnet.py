"""ResNet-18/34 encoder with ABN, NCHW.

Port of ``mgnet_tpu/models/resnet.py``: BasicStem (7x7/s2
conv-ABN + 3x3/s2 max pool), BasicBlocks with leaky-ABN conv1,
identity-ABN conv2 and shortcut, residual add then ReLU; stages res2..res5
at strides 4/8/16/32. The stem is a plain ``Conv2d(padding=3)``: the JAX
space-to-depth form (``resnet.py:63-104``) is a TPU layout trick over the
same variable tree. Every conv draws from ``kaiming_normal_fan_out``
(``"msra"``; the stem's ``"default"``), as the JAX encoder's. With
``remat`` each residual block runs under ``checkpoint_once`` while
gradients are on (``mgnet_tpu/models/resnet.py:175-186``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from mgnet_tpu_torch.models.abn import ConvABN, checkpoint_once

__all__ = ["ResNetABN", "BasicBlock", "BasicStem", "RESNET_STAGE_BLOCKS"]

RESNET_STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


class BasicStem(nn.Module):
    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1 = ConvABN(in_channels, 64, 7, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(self.conv1(x), 3, stride=2, padding=1)


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvABN(in_channels, out_channels, 3, stride=stride,
                             init_method="msra")
        self.conv2 = ConvABN(out_channels, out_channels, 3,
                             activation="identity", init_method="msra")
        self.shortcut = (
            ConvABN(in_channels, out_channels, 1, stride=stride,
                    activation="identity", init_method="msra")
            if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return F.relu(out + shortcut)


class ResNetABN(nn.Module):
    """NCHW image (3 channels, or 9 for the pose encoder's 3-frame concat)
    -> the ``out_features`` of {"res2": stride 4, 64 channels, "res3": 8,
    128, "res4": 16, 256, "res5": 32, 512}. Blocks are named like the JAX
    tree: ``res{2..5}_block{i}``."""

    def __init__(self, depth: int = 18, in_channels: int = 3,
                 out_features=("res3", "res4", "res5"), remat: bool = False):
        super().__init__()
        self.remat = remat
        self.out_features = tuple(out_features)
        self.stem = BasicStem(in_channels)
        self.block_names = []
        c_in, c_out = 64, 64
        for idx, n_blocks in enumerate(RESNET_STAGE_BLOCKS[depth]):
            stride = 1 if idx == 0 else 2
            for b in range(n_blocks):
                name = f"res{idx + 2}_block{b}"
                self.add_module(name, BasicBlock(
                    c_in, c_out, stride if b == 0 else 1))
                self.block_names.append(name)
                c_in = c_out
            c_out *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = self.stem(x)
        feats = {"stem": y}
        remat = self.remat and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            y = checkpoint_once(block, block, y) if remat else block(y)
            feats[name.split("_")[0]] = y
        return {k: v for k, v in feats.items() if k in self.out_features}
