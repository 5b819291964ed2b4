"""Multi-scale + horizontal-flip test-time augmentation.

Port of ``mgnet_tpu/inference/tta.py:29-108``: scales {0.5, 0.75, 1.0,
1.25, 1.5, 1.75, 2.0} x an optional flip, the flip pair batched into one
forward of [2B]; semantic logits are softmax-averaged; center, offset and
depth are averaged, depth in depth space (the head's inverse depth is
upsampled, then inverted); offsets are rescaled to original-image pixels
and their x component is negated when unflipping. All averaging runs in
float32 on the model's device.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from mgnet_tpu_torch.geometry.depth import inv2depth
from mgnet_tpu_torch.geometry.image import interpolate_bilinear

__all__ = ["DEFAULT_SCALES", "multi_scale_flip_inference"]

DEFAULT_SCALES = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0)


def multi_scale_flip_inference(
    model,
    norm_images: torch.Tensor,
    scales: Sequence[float] = DEFAULT_SCALES,
    flip: bool = True,
    with_panoptic: bool = True,
    with_depth: bool = True,
) -> Dict[str, torch.Tensor]:
    """Args:
        model: an MGNet in eval mode (the caller sets it and no_grad).
        norm_images: [B, H, W, 3] normalized images.

    Returns the averaged full-resolution 'sem_seg' (probabilities
    [B,H,W,C]), 'center' [B,H,W,1], 'offset' [B,H,W,2] with panoptic and
    'depth' [B,H,W,1] with depth.
    """
    b, h, w, _ = norm_images.shape
    stride = model.common_stride
    avg: Dict[str, torch.Tensor] = {}

    def acc(key, value):
        avg[key] = value if key not in avg else avg[key] + value

    def unflip_add(t, negate_x=False):
        if not flip:
            return t
        tf = torch.flip(t[b:], dims=[2])
        if negate_x:
            tf = tf * tf.new_tensor([1.0, -1.0])  # negate x-offsets
        return t[:b] + tf

    for scale in scales:
        x = interpolate_bilinear(norm_images, (int(h * scale),
                                               int(w * scale)))
        xi = torch.cat([x, torch.flip(x, dims=[2])]) if flip else x
        out = model(xi, upsample=False)
        if with_panoptic:
            r = interpolate_bilinear(out["sem_seg"].float(), (h, w))
            r = torch.exp(r - r.amax(dim=-1, keepdim=True))
            r = r / r.sum(dim=-1, keepdim=True)
            c = interpolate_bilinear(out["center"].float(), (h, w))
            o = interpolate_bilinear(out["offset"].float(),
                                     (h, w)) * (stride / scale)
            acc("sem_seg", unflip_add(r))
            acc("center", unflip_add(c))
            acc("offset", unflip_add(o, negate_x=True))
        if with_depth:
            # the inverse depth as the JAX function recovers it from the
            # eval output's depth, upsampled, then inverted
            inv = 1.0 / torch.clamp(out["depth"].float(), min=1e-6)
            acc("depth", unflip_add(inv2depth(
                interpolate_bilinear(inv, (h, w)))))

    n = len(scales) * (2 if flip else 1)
    return {k: v / n for k, v in avg.items()}
