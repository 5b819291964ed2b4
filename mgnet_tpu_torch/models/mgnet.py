"""MGNet for inference: shared ResNet encoder, GCM and three heads, NCHW.

Port of ``mgnet_tpu/models/mgnet.py:35-292`` for the eval path with
``upsample=False``: the heads return stride-8 maps and the fused frame
(inference/fused.py) upsamples them. The pose network and the multi-scale
depth heads come with the training slice.

``MGNet.forward`` takes a normalized NHWC image batch, runs NCHW inside
and returns NHWC head outputs, as the JAX model does. With
``dtype=torch.bfloat16`` the conv stack runs under
``torch.autocast(<device>, torch.bfloat16)`` with float32 parameters, the
counterpart of the JAX model's ``dtype=bfloat16``.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
from torch import nn

from mgnet_tpu_torch.geometry.depth import inv2depth
from mgnet_tpu_torch.models.abn import ABN
from mgnet_tpu_torch.models.layers import (
    GlobalContextModule,
    MGNetDecoder,
    MGNetHead,
)
from mgnet_tpu_torch.models.resnet import ResNetABN

__all__ = ["MGNet", "SemSegHead", "InsEmbedHead", "DepthHead", "build_model",
           "init_random_"]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class SemSegHead(nn.Module):
    def __init__(self, in_channels, num_classes, arm_channels,
                 refine_channels, ffm_channels, head_channels):
        super().__init__()
        self.decoder = MGNetDecoder(in_channels, arm_channels,
                                    refine_channels, ffm_channels)
        self.head = MGNetHead(ffm_channels, head_channels, num_classes)

    def forward(self, features):
        y, _ = self.decoder(features)
        return self.head(y)


class InsEmbedHead(nn.Module):
    """Center heatmap (sigmoid) and (dy, dx) offsets, at stride 8."""

    def __init__(self, in_channels, arm_channels, refine_channels,
                 ffm_channels, head_channels):
        super().__init__()
        self.decoder = MGNetDecoder(in_channels, arm_channels,
                                    refine_channels, ffm_channels)
        self.center_head = MGNetHead(ffm_channels, head_channels, 1)
        self.offset_head = MGNetHead(ffm_channels, head_channels, 2)

    def forward(self, features):
        y, _ = self.decoder(features)
        return torch.sigmoid(self.center_head(y)), self.offset_head(y)


class DepthHead(nn.Module):
    """Eval path: one inverse-depth head on the stride-8 features,
    sigmoid / 0.5 -> inverse depth in (0, 2), as float32."""

    def __init__(self, in_channels, arm_channels, refine_channels,
                 ffm_channels, head_channels):
        super().__init__()
        self.decoder = MGNetDecoder(in_channels, arm_channels,
                                    refine_channels, ffm_channels)
        self.head0 = MGNetHead(ffm_channels, head_channels, 1)

    def forward(self, features):
        y, _ = self.decoder(features)
        return (torch.sigmoid(self.head0(y)) / 0.5).float()


class MGNet(nn.Module):
    """Joint panoptic + depth network (eval). Both task branches always
    exist: the task toggles of the JAX config (WITH_PANOPTIC/WITH_DEPTH)
    come with the YAML configs of a later slice."""

    def __init__(self, num_classes: int = 20, depth: int = 18,
                 gcm_channels: int = 128, common_stride: int = 8,
                 head_channels: int = 256, ffm_channels: int = 256,
                 arm_channels: Sequence[int] = (128, 128),
                 refine_channels: Sequence[int] = (128, 128),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.common_stride = common_stride
        self.dtype = dtype
        self.backbone = ResNetABN(depth=depth)
        in_ch = {"res3": 128, "res4": 256, "res5": 512}
        self.global_context = GlobalContextModule(in_ch["res5"],
                                                  gcm_channels)
        common = dict(in_channels=in_ch, arm_channels=tuple(arm_channels),
                      refine_channels=tuple(refine_channels),
                      ffm_channels=ffm_channels, head_channels=head_channels)
        self.sem_seg_head = SemSegHead(num_classes=num_classes, **common)
        self.ins_embed_head = InsEmbedHead(**common)
        self.depth_head = DepthHead(**common)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Normalized NHWC images -> stride-8 NHWC head outputs:
        'sem_seg' logits, 'center', 'offset', 'inv_depth' (f32) and
        'depth'."""
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            feats = self.backbone(images.permute(0, 3, 1, 2))
            feats["global_context"] = self.global_context(feats["res5"])
            center, offset = self.ins_embed_head(feats)
            inv = _nhwc(self.depth_head(feats))
            return {"sem_seg": _nhwc(self.sem_seg_head(feats)),
                    "center": _nhwc(center), "offset": _nhwc(offset),
                    "inv_depth": inv, "depth": inv2depth(inv)}


def build_model(cfg, device="cuda") -> MGNet:
    """MGNet from a config (mgnet_tpu_torch.config), in eval mode on
    ``device``. Weights are the constructor's; load real ones with
    utils.weights.load_jax_params or draw them with init_random_."""
    h = cfg.MODEL.SEM_SEG_HEAD
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    model = MGNet(
        num_classes=h.NUM_CLASSES,
        depth=cfg.MODEL.RESNETS.DEPTH,
        gcm_channels=cfg.MODEL.GCM.GCM_CHANNELS,
        common_stride=h.COMMON_STRIDE,
        head_channels=h.HEAD_CHANNELS,
        ffm_channels=h.FFM_CHANNELS,
        arm_channels=tuple(h.ARM_CHANNELS),
        refine_channels=tuple(h.REFINE_CHANNELS),
        dtype=dtypes[cfg.MODEL.COMPUTE_DTYPE],
    )
    return model.to(device).eval()


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Draw conv weights from N(0, 1/fan_in) (the JAX package's
    ``mgnet_xavier_init``) with ``generator`` and reset ABN to its identity
    (scale 1, bias 0, mean 0, var 1). ``generator`` must live on the
    parameters' device."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            w = torch.randn(m.weight.shape, generator=generator,
                            device=m.weight.device)
            m.weight.copy_(w / math.sqrt(fan_in))
        elif isinstance(m, ABN):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
