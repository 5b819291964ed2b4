"""Activated batch normalization: conv + BN + activation.

Port of ``mgnet_tpu/models/abn.py:67-217``. BN is evaluated in float32
whatever the input dtype, then cast back (as ``BatchNormTorch`` does);
the activation is leaky_relu(0.01) or identity. Parameter names follow
the JAX tree with the ``BatchNorm_0`` level folded in:
``abn/BatchNorm_0/{scale,bias,mean,var}`` ->
``abn.{weight,bias,running_mean,running_var}`` (utils/weights.py).

``module.train()`` normalizes with the batch statistics over (N, H, W),
in f32: the one-pass ``max(0, E[x^2] - E[x]^2)`` variance, or with
``fast_variance=False`` (the pooled [B, C, 1, 1] sites of the GCM and the
ARM attention) the two-pass ``E[(x - E[x])^2]``. It then updates the
running statistics as ``0.99 * running + 0.01 * batch``, storing the
unbiased variance (x n / (n - 1)): the JAX package's ``BN_MOMENTUM =
0.99`` in flax form, torch momentum 0.01. ``module.eval()`` normalizes
with the running statistics.

Under data parallelism (``parallel.collectives``, world > 1) the batch
statistics are the global batch's, as the JAX step's
(``mgnet_tpu/models/abn.py:117-140``): the one-pass path averages the
stacked per-rank [E[x], E[x^2]] in one differentiable all-reduce; the
two-pass path takes two, the global mean and then the global
E[(x - mean)^2]; n counts every rank's values. Each rank applies the same
update to its running statistics, so they stay equal without a
broadcast.

Each conv records, as ``conv.init``, the rule its JAX counterpart draws its
kernel from (``mgnet_tpu/models/abn.py:37-63``, ``layers.py:116-232``),
and ``init_conv_`` draws it so: ``kaiming_normal_fan_out``,
N(0, 2 / (kh kw out)), for the ResNet convs and the ``"default"`` and
``"msra"`` methods; ``mgnet_xavier_init``, N(0, 1 / (kh kw in)), for
``"xavier"``; ``lecun_normal``, flax's normal truncated at +-2 sigma and
rescaled by 1 / 0.87962566 so that its std is sqrt(1 / (kh kw in)), for
the predictors of a non-xavier head.

``checkpoint_once`` is ``torch.utils.checkpoint`` for a module that holds
ABN: the recompute in the backward normalizes with the same batch
statistics (all-reducing again, on every rank at the same point of the
backward) but leaves the running ones alone, so that they update once a
forward, as under the JAX package's functional ``nn.remat``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mgnet_tpu_torch.parallel.collectives import all_mean
from mgnet_tpu_torch.parallel.multihost import data_count, process_count

__all__ = ["ABN", "ConvABN", "BN_EPS", "BN_MOMENTUM", "INITS",
           "checkpoint_once", "init_conv_", "recorded"]

BN_EPS = 1e-5
BN_MOMENTUM = 0.99  # flax form: running = momentum * running + (1 - m) * batch

# a config's INIT_METHOD -> the rule its ConvABN kernels draw from
INITS = {"default": "kaiming_normal_fan_out", "msra": "kaiming_normal_fan_out",
         "xavier": "mgnet_xavier_init"}
# flax's truncated_normal: the std of a unit normal truncated at +-2
_TRUNCATED_STD = 0.87962566103423978


def recorded(conv: nn.Conv2d, rule: str) -> nn.Conv2d:
    """``conv`` with ``rule`` recorded as the init its kernel draws from."""
    if rule not in ("kaiming_normal_fan_out", "mgnet_xavier_init",
                    "lecun_normal"):
        raise ValueError(f"unknown init rule {rule!r}")
    conv.init = rule
    return conv


@torch.no_grad()
def init_conv_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """Draw ``conv``'s kernel by its recorded rule with ``generator`` (on
    the kernel's device) and zero its bias."""
    w = conv.weight
    out_c, in_c, kh, kw = w.shape
    if conv.init == "kaiming_normal_fan_out":
        std = math.sqrt(2.0 / (kh * kw * out_c))
    else:
        std = math.sqrt(1.0 / (kh * kw * in_c))
    if conv.init == "lecun_normal":
        unit = torch.empty(w.shape, device=w.device)
        nn.init.trunc_normal_(unit, generator=generator)
        w.copy_(unit * (std / _TRUNCATED_STD))
    else:
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device)
                * std)
    if conv.bias is not None:
        conv.bias.zero_()


class ABN(nn.Module):
    """BatchNorm over the channel axis of NCHW + activation."""

    def __init__(self, channels: int, activation: str = "leaky_relu",
                 fast_variance: bool = True):
        super().__init__()
        if activation not in ("leaky_relu", "identity"):
            raise ValueError(f"Unsupported ABN activation: {activation}")
        self.activation = activation
        self.fast_variance = fast_variance
        # False while checkpoint_once recomputes the forward
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def _batch_stats(self, xf: torch.Tensor):
        dims = (0, 2, 3)
        world = process_count()
        mean = xf.mean(dim=dims)
        if self.fast_variance:
            mean2 = (xf * xf).mean(dim=dims)
            if world > 1:
                mean, mean2 = all_mean(torch.stack([mean, mean2])).unbind(0)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
        else:
            mean = all_mean(mean)
            var = all_mean(torch.square(xf - mean[:, None, None])
                           .mean(dim=dims))
        if not self.update_stats:
            return mean, var
        with torch.no_grad():
            # the global batch's count: copies on a model axis excluded
            n = xf.numel() // xf.shape[1] * data_count()
            correction = n / (n - 1) if n > 1 else 1.0
            m = BN_MOMENTUM
            self.running_mean.mul_(m).add_((1 - m) * mean)
            self.running_var.mul_(m).add_((1 - m) * var * correction)
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean, var = self._batch_stats(xf)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        y = y.to(x.dtype)
        if self.activation == "leaky_relu":
            y = F.leaky_relu(y, negative_slope=0.01)
        return y


class ConvABN(nn.Module):
    """Bias-free Conv2d with torch-style symmetric padding k//2, then ABN;
    the kernel draws from ``INITS[init_method]``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 activation: str = "leaky_relu",
                 fast_variance: bool = True, init_method: str = "default"):
        super().__init__()
        self.conv = recorded(nn.Conv2d(in_channels, out_channels,
                                       kernel_size, stride=stride,
                                       padding=kernel_size // 2, bias=False),
                             INITS[init_method])
        self.abn = ABN(out_channels, activation, fast_variance)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.abn(self.conv(x))


def checkpoint_once(module: nn.Module, fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant, no RNG
    state: the model draws none), where ``fn`` runs ``module``: the
    forward's activations inside are dropped and recomputed in the
    backward, and each ABN of ``module`` updates its running statistics in
    the first run only."""
    abns = [m for m in module.modules() if isinstance(m, ABN)]
    first = True

    def run(*a):
        nonlocal first
        if first:
            first = False
            return fn(*a)
        for m in abns:
            m.update_stats = False
        try:
            return fn(*a)
        finally:
            for m in abns:
                m.update_stats = True

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)
