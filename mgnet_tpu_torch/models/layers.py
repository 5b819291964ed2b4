"""MGNet decoder building blocks: GCM, ARM, FFM, decoder and head, NCHW.

Port of ``mgnet_tpu/models/layers.py``, with the pose network ``PoseCNN``.
Module and attribute names follow the JAX variable tree so that weights
carry across by name (utils/weights.py). The pooled [B, C, 1, 1] BN sites
(the GCM and the ARM attention) use the two-pass batch variance in
training, as the JAX package does. Each module takes the ``init_method``
of its config (``INIT_METHOD``) for its conv-ABNs; the FFM attention and
PoseCNN decoder convs draw from ``mgnet_xavier_init`` whatever it is, and a
head's predictor from it under ``"xavier"``, else from ``lecun_normal``,
as in the JAX package (models/abn.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from mgnet_tpu_torch.geometry.image import interpolate_nearest
from mgnet_tpu_torch.models.abn import ConvABN, recorded
from mgnet_tpu_torch.models.resnet import ResNetABN

__all__ = [
    "GlobalContextModule",
    "AttentionRefinementModule",
    "FeatureFusionModule",
    "MGNetDecoder",
    "MGNetHead",
    "PoseCNN",
]


def _global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3), keepdim=True)


class GlobalContextModule(nn.Module):
    """Global avg-pool -> 1x1 conv-ABN -> broadcast to the input size."""

    def __init__(self, in_channels: int, out_channels: int = 128,
                 init_method: str = "xavier"):
        super().__init__()
        self.conv = ConvABN(in_channels, out_channels, 1,
                            fast_variance=False, init_method=init_method)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(_global_avg_pool(x))
        return y.expand(-1, -1, x.shape[2], x.shape[3])


class AttentionRefinementModule(nn.Module):
    """3x3 conv-ABN, then channel attention (pool -> 1x1 conv-ABN-identity
    -> sigmoid) multiplied in."""

    def __init__(self, in_channels: int, out_channels: int,
                 init_method: str = "xavier"):
        super().__init__()
        self.conv = ConvABN(in_channels, out_channels, 3,
                            init_method=init_method)
        self.attention_conv = ConvABN(out_channels, out_channels, 1,
                                      activation="identity",
                                      fast_variance=False,
                                      init_method=init_method)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fm = self.conv(x)
        atten = torch.sigmoid(self.attention_conv(_global_avg_pool(fm)))
        return fm * atten


class FeatureFusionModule(nn.Module):
    """concat -> 1x1 conv-ABN -> channel attention -> fm + fm * atten."""

    def __init__(self, in_channels: int, out_channels: int,
                 init_method: str = "xavier"):
        super().__init__()
        self.conv = ConvABN(in_channels, out_channels, 1,
                            init_method=init_method)
        self.attention_conv1 = recorded(nn.Conv2d(
            out_channels, out_channels, 1, bias=False), "mgnet_xavier_init")
        self.attention_conv2 = recorded(nn.Conv2d(
            out_channels, out_channels, 1, bias=False), "mgnet_xavier_init")

    def forward(self, fsp: torch.Tensor, fcp: torch.Tensor) -> torch.Tensor:
        fm = self.conv(torch.cat([fsp, fcp], dim=1))
        atten = torch.relu(self.attention_conv1(_global_avg_pool(fm)))
        atten = torch.sigmoid(self.attention_conv2(atten))
        return fm + fm * atten


class MGNetDecoder(nn.Module):
    """BiSeNet-style decoder over (res5, res4, res3) + global context.

    Returns (fused, msc_features); msc_features are the post-add ARM maps
    at strides 32 and 16. ``arm_channels[0]`` must equal the global
    context's channels and ``arm_channels[1]`` ``refine_channels[0]``:
    each ARM output is added to them.
    """

    def __init__(self, in_channels: Dict[str, int],
                 arm_channels: Sequence[int] = (128, 128),
                 refine_channels: Sequence[int] = (128, 128),
                 ffm_channels: int = 256, init_method: str = "xavier"):
        super().__init__()
        coarse_in = [in_channels["res5"], in_channels["res4"]]
        for i in range(2):
            self.add_module(f"arm{i}", AttentionRefinementModule(
                coarse_in[i], arm_channels[i], init_method))
            self.add_module(f"refine{i}", ConvABN(
                arm_channels[i], refine_channels[i], 3,
                init_method=init_method))
        self.ffm = FeatureFusionModule(
            in_channels["res3"] + refine_channels[1], ffm_channels,
            init_method)

    def forward(self, features: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        coarse = [features["res5"], features["res4"]]
        finest = features["res3"]
        last_fm = features["global_context"]
        msc: List[torch.Tensor] = []
        for i, fm_in in enumerate(coarse):
            fm = getattr(self, f"arm{i}")(fm_in) + last_fm
            msc.append(fm)
            nxt = coarse[i + 1] if i + 1 < len(coarse) else finest
            last_fm = interpolate_nearest(fm, tuple(nxt.shape[2:]))
            last_fm = getattr(self, f"refine{i}")(last_fm)
        return self.ffm(finest, last_fm), msc


class MGNetHead(nn.Module):
    """3x3 conv-ABN -> 1x1 bias-free predictor conv."""

    def __init__(self, in_channels: int, head_channels: int,
                 num_classes: int, init_method: str = "xavier"):
        super().__init__()
        self.head = ConvABN(in_channels, head_channels, 3,
                            init_method=init_method)
        self.predictor = recorded(
            nn.Conv2d(head_channels, num_classes, 1, bias=False),
            "mgnet_xavier_init" if init_method == "xavier"
            else "lecun_normal")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.predictor(self.head(x))


class PoseCNN(nn.Module):
    """Pose regression: a ResNet encoder over the channel concat of (current,
    previous, next) frames, convs 1-4 with biases and ReLU between them, a
    spatial mean, x 0.01 -> [B, num_context, 6] (tx, ty, tz, rx, ry, rz),
    float32."""

    def __init__(self, depth: int = 18, num_context_images: int = 2,
                 remat: bool = False):
        super().__init__()
        self.num_context_images = num_context_images
        self.encoder = ResNetABN(depth=depth,
                                 in_channels=3 * (num_context_images + 1),
                                 out_features=("res5",), remat=remat)
        for i, (c_in, c_out, k) in enumerate(
                ((512, 256, 1), (256, 256, 3), (256, 256, 3),
                 (256, 6 * num_context_images, 1)), 1):
            self.add_module(f"conv{i}", recorded(
                nn.Conv2d(c_in, c_out, k, padding=k // 2),
                "mgnet_xavier_init"))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        y = self.encoder(images)["res5"]
        y = torch.relu(self.conv1(y))
        y = torch.relu(self.conv2(y))
        y = torch.relu(self.conv3(y))
        y = self.conv4(y).mean(dim=(2, 3))
        y = 0.01 * y.reshape(y.shape[0], self.num_context_images, 6)
        return y.float()
