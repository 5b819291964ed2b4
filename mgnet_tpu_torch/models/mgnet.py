"""MGNet: shared ResNet encoder, GCM, three heads and the pose network, NCHW.

Port of ``mgnet_tpu/models/mgnet.py``.

``MGNet.forward`` is the eval path: it takes a normalized NHWC image batch
and returns the NHWC head outputs, at stride 8 (the fused frame,
inference/fused.py, upsamples them) or, with ``upsample=True``, at full
resolution as the JAX model's eval call gives them.

``MGNet.forward_train(image, image_prev, image_next)`` is the training
forward (``mgnet_tpu/models/mgnet.py:118-273``): the heads upsampled to
full resolution with the align-corners bilinear resize (offsets then
x common_stride), the depth head over three scales (``head0`` on the
stride-8 features, ``head1``/``head2`` on the decoder's stride-16/32 maps)
when ``msc_depth_loss``, and the pose network on the 9-channel channel
concat of the three normalized frames. Call it with the module in train
mode for batch-statistics BN, as the JAX training step does.

``with_panoptic`` and ``with_depth`` (the config's ``WITH_PANOPTIC`` and
``WITH_DEPTH``) select the task branches: a panoptic-only model has no
depth head and no pose net and takes no context frames; a depth-only
model has no semantic or instance head. The pose network and the
multi-scale depth heads exist only in a model built ``for_training``, as
their variables exist in the JAX package only when it is initialised
through ``forward_train``.

With ``remat`` (``MODEL.REMAT``) every residual block of both encoders and
each of the three heads run under ``models.abn.checkpoint_once`` in
training: their activations are recomputed in the backward
(``mgnet_tpu/models/mgnet.py:206-215``).

With ``dtype=torch.bfloat16`` the conv stack runs under
``torch.autocast(<device>, torch.bfloat16)`` with float32 parameters, the
counterpart of the JAX model's ``dtype=bfloat16``; each resize computes in
float32 and casts back to its input's dtype, as the JAX package's
``interpolate_bilinear`` does.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from mgnet_tpu_torch.geometry.depth import inv2depth
from mgnet_tpu_torch.geometry.image import interpolate_bilinear_cf
from mgnet_tpu_torch.models.abn import ABN, checkpoint_once, init_conv_
from mgnet_tpu_torch.models.layers import (
    GlobalContextModule,
    MGNetDecoder,
    MGNetHead,
    PoseCNN,
)
from mgnet_tpu_torch.models.resnet import ResNetABN

__all__ = ["MGNet", "SemSegHead", "InsEmbedHead", "DepthHead", "build_model",
           "init_random_"]

# each branch's INIT_METHOD when the constructor is given none: the
# config's defaults, which are the JAX modules' own
INIT_METHODS = {"gcm": "xavier", "sem_seg": "xavier", "ins_embed": "xavier",
                "depth": "default"}


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _upsample(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Align-corners bilinear resize by ``stride``, in f32, cast back."""
    size = (x.shape[2] * stride, x.shape[3] * stride)
    return interpolate_bilinear_cf(x, size).to(x.dtype)


class SemSegHead(nn.Module):
    def __init__(self, in_channels, num_classes, arm_channels,
                 refine_channels, ffm_channels, head_channels,
                 common_stride=8, init_method="xavier"):
        super().__init__()
        self.common_stride = common_stride
        self.decoder = MGNetDecoder(in_channels, arm_channels,
                                    refine_channels, ffm_channels,
                                    init_method)
        self.head = MGNetHead(ffm_channels, head_channels, num_classes,
                              init_method)

    def forward(self, features, upsample: bool = False):
        y, _ = self.decoder(features)
        y = self.head(y)
        return _upsample(y, self.common_stride) if upsample else y


class InsEmbedHead(nn.Module):
    """Center heatmap (sigmoid) and (dy, dx) offsets; at stride 8, or
    upsampled with the offsets in output pixels."""

    def __init__(self, in_channels, arm_channels, refine_channels,
                 ffm_channels, head_channels, common_stride=8,
                 init_method="xavier"):
        super().__init__()
        self.common_stride = common_stride
        self.decoder = MGNetDecoder(in_channels, arm_channels,
                                    refine_channels, ffm_channels,
                                    init_method)
        self.center_head = MGNetHead(ffm_channels, head_channels, 1,
                                     init_method)
        self.offset_head = MGNetHead(ffm_channels, head_channels, 2,
                                     init_method)

    def forward(self, features, upsample: bool = False):
        y, _ = self.decoder(features)
        center = torch.sigmoid(self.center_head(y))
        offset = self.offset_head(y)
        if upsample:
            center = _upsample(center, self.common_stride)
            offset = _upsample(offset, self.common_stride) \
                * self.common_stride
        return center, offset


class DepthHead(nn.Module):
    """Inverse-depth heads, sigmoid / 0.5 -> inverse depth in (0, 2), as
    float32: ``head0`` on the stride-8 features; with ``msc_heads``,
    ``head1`` and ``head2`` on the decoder's stride-16 and stride-32 maps
    (``msc[1]``, ``msc[0]``) in training."""

    def __init__(self, in_channels, arm_channels, refine_channels,
                 ffm_channels, head_channels, common_stride=8,
                 msc_heads: bool = False, init_method="default"):
        super().__init__()
        self.common_stride = common_stride
        self.msc_heads = msc_heads
        self.decoder = MGNetDecoder(in_channels, arm_channels,
                                    refine_channels, ffm_channels,
                                    init_method)
        self.head0 = MGNetHead(ffm_channels, head_channels, 1, init_method)
        if msc_heads:
            self.head1 = MGNetHead(arm_channels[1], head_channels, 1,
                                   init_method)
            self.head2 = MGNetHead(arm_channels[0], head_channels, 1,
                                   init_method)

    def _inv_depth(self, head, f, size):
        d = torch.sigmoid(head(f)) / 0.5
        if size is not None:
            d = interpolate_bilinear_cf(d, size).to(d.dtype)
        return d.float()

    def _size(self, y):
        return (y.shape[2] * self.common_stride,
                y.shape[3] * self.common_stride)

    def forward(self, features, upsample: bool = False):
        """Eval: [B, 1, H/8, W/8] inverse depth, or [B, 1, H, W] with
        ``upsample``."""
        y, _ = self.decoder(features)
        return self._inv_depth(self.head0, y,
                               self._size(y) if upsample else None)

    def forward_train(self, features):
        """Training: the list of full-resolution inverse depths, finest
        first."""
        y, msc = self.decoder(features)
        inputs = [y]
        if self.msc_heads:
            inputs += [msc[1], msc[0]]
        return [self._inv_depth(getattr(self, f"head{i}"), f, self._size(y))
                for i, f in enumerate(inputs)]


class MGNet(nn.Module):
    """Joint panoptic + self-supervised depth network."""

    def __init__(self, num_classes: int = 20, depth: int = 18,
                 gcm_channels: int = 128, common_stride: int = 8,
                 head_channels: int = 256, ffm_channels: int = 256,
                 arm_channels: Sequence[int] = (128, 128),
                 refine_channels: Sequence[int] = (128, 128),
                 dtype: torch.dtype = torch.float32,
                 for_training: bool = False, msc_depth_loss: bool = True,
                 with_panoptic: bool = True, with_depth: bool = True,
                 remat: bool = False,
                 init_methods: Optional[Dict[str, str]] = None):
        super().__init__()
        if not (with_panoptic or with_depth):
            raise ValueError("MGNet needs at least one task branch")
        self.common_stride = common_stride
        self.dtype = dtype
        self.with_panoptic = with_panoptic
        self.with_depth = with_depth
        self.remat = remat
        init = {**INIT_METHODS, **(init_methods or {})}
        self.backbone = ResNetABN(depth=depth, remat=remat)
        in_ch = {"res3": 128, "res4": 256, "res5": 512}
        self.global_context = GlobalContextModule(in_ch["res5"],
                                                  gcm_channels, init["gcm"])
        common = dict(in_channels=in_ch, arm_channels=tuple(arm_channels),
                      refine_channels=tuple(refine_channels),
                      ffm_channels=ffm_channels, head_channels=head_channels,
                      common_stride=common_stride)
        if with_panoptic:
            self.sem_seg_head = SemSegHead(num_classes=num_classes,
                                           init_method=init["sem_seg"],
                                           **common)
            self.ins_embed_head = InsEmbedHead(init_method=init["ins_embed"],
                                               **common)
        if with_depth:
            self.depth_head = DepthHead(
                msc_heads=for_training and msc_depth_loss,
                init_method=init["depth"], **common)
            if for_training:
                self.pose_net = PoseCNN(depth=depth, remat=remat)

    def _autocast(self, device_type: str):
        return torch.autocast(device_type, dtype=torch.bfloat16,
                              enabled=self.dtype == torch.bfloat16)

    def _features(self, images_nchw: torch.Tensor):
        feats = self.backbone(images_nchw)
        feats["global_context"] = self.global_context(feats["res5"])
        return feats

    def _head(self, head: nn.Module, fn, feats):
        """``fn(feats)`` of ``head``, under checkpoint_once with remat."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint_once(head, fn, feats)
        return fn(feats)

    def forward(self, images: torch.Tensor,
                upsample: bool = False) -> Dict[str, torch.Tensor]:
        """Normalized NHWC images -> NHWC head outputs, at stride 8 or
        (``upsample``) full resolution: 'sem_seg' logits, 'center' and
        'offset' with panoptic; 'inv_depth' (f32) and 'depth' with
        depth."""
        out: Dict[str, torch.Tensor] = {}
        with self._autocast(images.device.type):
            feats = self._features(images.permute(0, 3, 1, 2))
            if self.with_panoptic:
                out["sem_seg"] = _nhwc(self.sem_seg_head(feats, upsample))
                center, offset = self.ins_embed_head(feats, upsample)
                out["center"], out["offset"] = _nhwc(center), _nhwc(offset)
            if self.with_depth:
                inv = _nhwc(self.depth_head(feats, upsample))
                out["inv_depth"], out["depth"] = inv, inv2depth(inv)
        return out

    def forward_train(self, image: torch.Tensor,
                      image_prev: Optional[torch.Tensor] = None,
                      image_next: Optional[torch.Tensor] = None
                      ) -> Dict[str, object]:
        """Normalized NHWC frames -> full-resolution NHWC outputs: with
        panoptic 'sem_seg', 'center', 'offset'; with depth the list
        'inv_depths' ([B, H, W, 1] f32, finest first) and 'poses'
        ([B, 2, 6] f32) from the current frame and the two context frames,
        which only a model with depth takes."""
        if self.with_depth and not hasattr(self, "pose_net"):
            raise RuntimeError("forward_train needs a model built "
                               "for_training (pose net, depth heads)")
        if self.with_depth != (image_prev is not None
                               and image_next is not None):
            raise ValueError("forward_train takes the two context frames "
                             "exactly when the model has depth")
        with self._autocast(image.device.type):
            x = image.permute(0, 3, 1, 2)
            feats = self._features(x)
            out: Dict[str, object] = {}
            if self.with_panoptic:
                out["sem_seg"] = _nhwc(self._head(
                    self.sem_seg_head,
                    lambda f: self.sem_seg_head(f, upsample=True), feats))
                center, offset = self._head(
                    self.ins_embed_head,
                    lambda f: self.ins_embed_head(f, upsample=True), feats)
                out["center"], out["offset"] = _nhwc(center), _nhwc(offset)
            if self.with_depth:
                out["inv_depths"] = [_nhwc(d) for d in self._head(
                    self.depth_head, self.depth_head.forward_train, feats)]
                cat = torch.cat([x, image_prev.permute(0, 3, 1, 2),
                                 image_next.permute(0, 3, 1, 2)], dim=1)
                out["poses"] = self.pose_net(cat)
        return out


def build_model(cfg, device="cuda", for_training: bool = False) -> MGNet:
    """MGNet from a config (mgnet_tpu_torch.config) on ``device``, with the
    config's task branches and remat: in eval mode, or with the pose net
    and multi-scale depth heads in train mode when ``for_training``.
    Weights are the constructor's; load real ones with
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
        for_training=for_training,
        msc_depth_loss=cfg.MODEL.DEPTH_HEAD.MSC_LOSS,
        with_panoptic=cfg.WITH_PANOPTIC,
        with_depth=cfg.WITH_DEPTH,
        remat=cfg.MODEL.REMAT,
        init_methods={"gcm": cfg.MODEL.GCM.INIT_METHOD,
                      "sem_seg": h.INIT_METHOD,
                      "ins_embed": cfg.MODEL.INS_EMBED_HEAD.INIT_METHOD,
                      "depth": cfg.MODEL.DEPTH_HEAD.INIT_METHOD},
    )
    model = model.to(device)
    return model.train() if for_training else model.eval()


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Draw each conv's kernel by the rule it records (``models.abn``: the
    JAX package's initializer of that conv) with ``generator``, zero conv
    biases, and reset ABN to its identity (scale 1, bias 0, mean 0, var
    1). ``generator`` must live on the parameters' device."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            init_conv_(m, generator)
        elif isinstance(m, ABN):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


def as_float64_(model: MGNet) -> MGNet:
    """Turn ``model`` into its float64 reference, in place: parameters and
    buffers in float64, and ``forward`` and ``forward_train`` casting their
    floating inputs to float64. A float32 run is held to it where two
    float32 runs may differ by rounding alone. The losses and the kernels
    stay float32, as they cast their inputs, and so do the outputs that
    the model casts to float32 (inverse depths, poses): one rounding at
    the end. Returns ``model``."""
    model.double()
    model.dtype = torch.float64
    for name in ("forward", "forward_train"):
        setattr(model, name, functools.partial(_in_float64,
                                               getattr(model, name)))
    return model


def _in_float64(fn, *args, **kwargs):
    def cast(x):
        return x.double() if torch.is_tensor(x) and x.is_floating_point() \
            else x

    return fn(*map(cast, args), **{k: cast(v) for k, v in kwargs.items()})
