"""Activated batch normalization in eval mode: conv + BN + activation.

Port of ``mgnet_tpu/models/abn.py:67-217`` for inference. BN uses the
running statistics with eps 1e-5 and is evaluated in float32 whatever the
input dtype, then cast back (as ``BatchNormTorch`` does); the activation is
leaky_relu(0.01) or identity. Parameter names follow the JAX tree with the
``BatchNorm_0`` level folded in: ``abn/BatchNorm_0/{scale,bias,mean,var}``
-> ``abn.{weight,bias,running_mean,running_var}`` (utils/weights.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ABN", "ConvABN", "BN_EPS"]

BN_EPS = 1e-5


class ABN(nn.Module):
    """Eval-mode BatchNorm over the channel axis of NCHW + activation."""

    def __init__(self, channels: int, activation: str = "leaky_relu"):
        super().__init__()
        if activation not in ("leaky_relu", "identity"):
            raise ValueError(f"Unsupported ABN activation: {activation}")
        self.activation = activation
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) \
            * mul[:, None, None] + self.bias[:, None, None]
        y = y.to(x.dtype)
        if self.activation == "leaky_relu":
            y = F.leaky_relu(y, negative_slope=0.01)
        return y


class ConvABN(nn.Module):
    """Bias-free Conv2d with torch-style symmetric padding k//2, then ABN."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 activation: str = "leaky_relu"):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=kernel_size // 2,
                              bias=False)
        self.abn = ABN(out_channels, activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.abn(self.conv(x))
