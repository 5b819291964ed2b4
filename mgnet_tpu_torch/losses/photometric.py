"""Self-supervised multi-view photometric loss.

Port of ``mgnet_tpu/losses/photometric.py::multi_view_photometric_loss``:
per context frame, warp it into the current view through the predicted
depth and pose (``view_synthesis_planar``, the warp kernel on the card);
photometric residual = channel mean of 0.85 * SSIM + 0.15 * L1
(``fused_photometric_residual``, the SSIM kernels on the card); with
automasking, the unwarped context's residual joins the candidates; the
per-pixel minimum over candidates is averaged over the reprojection mask,
then over scales; plus the edge-aware smoothness of the mean-normalized
inverse depth with weight 1/2^i per scale (no extra /2).

Everything runs in float32, on channel-planar [B, C, H, W] tensors inside;
the arguments keep the JAX package's NHWC layout.

Under data parallelism (``parallel.collectives``, world > 1) the masked
sums and the mask sums are over the global batch, as in the JAX
package's SPMD step: each scale's photometric and smoothness sum through
the differentiable ``all_sum``, the mask sums through ``reduce_``. The
per-sample terms (each sample's mean inverse depth) stay local.

``ssim`` is the plain SSIM loss map of ``mgnet_tpu/losses/photometric.py:50``
(NHWC, 3x3 average pools over reflect padding); the loss above does not
call it: its residual is the fused kernel's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from mgnet_tpu_torch.geometry import (
    Camera,
    Pose,
    inv2depth,
    view_synthesis_planar,
)
from mgnet_tpu_torch.ops.ssim import fused_photometric_residual
from mgnet_tpu_torch.parallel.collectives import all_sum, reduce_

__all__ = ["multi_view_photometric_loss", "ssim"]


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 'valid' average pool of NHWC, in the JAX function's
    shifted-add order."""
    r = x[:, :-2] + x[:, 1:-1] + x[:, 2:]
    s = r[:, :, :-2] + r[:, :, 1:-1] + r[:, :, 2:]
    return s / 9.0


def ssim(x: torch.Tensor, y: torch.Tensor, c1: float = 1e-4,
         c2: float = 9e-4) -> torch.Tensor:
    """SSIM loss map clamp((1 - SSIM) / 2, 0, 1) of NHWC images, with the
    statistics over 3x3 pools of the reflect-padded images."""
    def pad(t):
        return F.pad(t.permute(0, 3, 1, 2), (1, 1, 1, 1),
                     mode="reflect").permute(0, 2, 3, 1)

    xp, yp = pad(x), pad(y)
    mu_x, mu_y = _avg_pool3(xp), _avg_pool3(yp)
    mu_xy, mu_xx, mu_yy = mu_x * mu_y, mu_x * mu_x, mu_y * mu_y
    sigma_x = _avg_pool3(xp * xp) - mu_xx
    sigma_y = _avg_pool3(yp * yp) - mu_yy
    sigma_xy = _avg_pool3(xp * yp) - mu_xy
    ssim_val = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2))
    return torch.clamp((1.0 - ssim_val) / 2.0, 0.0, 1.0)


def _planar(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2).contiguous()


def multi_view_photometric_loss(
    inv_depths: List[torch.Tensor],
    poses: torch.Tensor,
    camera_matrix: torch.Tensor,
    image: torch.Tensor,
    context_images: List[torch.Tensor],
    reprojection_mask: Optional[torch.Tensor] = None,
    *,
    ssim_loss_weight: float = 0.85,
    photometric_loss_weight: float = 1.0,
    smoothing_loss_weight: float = 0.001,
    automask_loss: bool = True,
    photometric_reduce_op: str = "min",
    padding_mode: str = "zeros",
) -> Dict[str, torch.Tensor]:
    """Photometric and smoothness losses.

    Args:
        inv_depths: [B, H, W, 1] inverse depths, all at full resolution.
        poses: [B, num_context, 6] pose vectors (t, euler) of the context
            frames.
        camera_matrix: [B, 3, 3] intrinsics.
        image: [B, H, W, 3] current frame in [0, 1].
        context_images: [B, H, W, 3] context frames matching poses[:, j].
        reprojection_mask: [B, H, W, 1] or [B, H, W] validity mask.
    """
    with torch.autocast(image.device.type, enabled=False):
        return _loss(inv_depths, poses, camera_matrix, image, context_images,
                     reprojection_mask, ssim_loss_weight,
                     photometric_loss_weight, smoothing_loss_weight,
                     automask_loss, photometric_reduce_op, padding_mode)


def _loss(inv_depths, poses, camera_matrix, image, context_images,
          reprojection_mask, ssim_loss_weight, photometric_loss_weight,
          smoothing_loss_weight, automask_loss, photometric_reduce_op,
          padding_mode):
    n = len(inv_depths)
    inv_depths = [d.float() for d in inv_depths]
    camera_matrix = camera_matrix.float()
    poses = poses.float()
    image_pl = _planar(image)
    if reprojection_mask is None:
        mask = torch.ones_like(image_pl[:, 0])
    else:
        mask = reprojection_mask.float()
        if mask.dim() == 4:
            mask = mask[..., 0]
    if automask_loss and photometric_reduce_op != "min":
        raise ValueError("automasking requires the min photometric "
                         "reduction")

    def photo(a: torch.Tensor) -> torch.Tensor:
        """Residual [B, H, W] of planar frame ``a`` against the image."""
        if ssim_loss_weight > 0.0:
            return fused_photometric_residual(a, image_pl, ssim_loss_weight)
        return torch.abs(a - image_pl).mean(dim=1)

    depths = [inv2depth(d) for d in inv_depths]
    cam = Camera(K=camera_matrix)
    candidates: List[List[torch.Tensor]] = [[] for _ in range(n)]
    for j, ref_image in enumerate(context_images):
        ref_pl = _planar(ref_image)
        ref_cam = Camera(K=camera_matrix, Tcw=Pose.from_vec(poses[:, j]))
        unwarped = photo(ref_pl) if automask_loss else None
        for i in range(n):
            warped = view_synthesis_planar(ref_pl, depths[i], ref_cam, cam,
                                           padding_mode=padding_mode)
            candidates[i].append(photo(warped))
            if automask_loss:
                candidates[i].append(unwarped)

    mask_sum = torch.clamp(reduce_(mask.sum()), min=1.0)

    def reduce_scale(cands: List[torch.Tensor]) -> torch.Tensor:
        stacked = torch.stack(cands, dim=0)
        if photometric_reduce_op == "min":
            m = torch.amin(stacked, dim=0)
        elif photometric_reduce_op == "mean":
            m = stacked.mean(dim=0)
        else:
            raise ValueError(
                f"Unknown photometric_reduce_op: {photometric_reduce_op}")
        return all_sum((m * mask).sum()) / mask_sum

    photometric_loss = sum(reduce_scale(candidates[i])
                           for i in range(n)) / n

    inv_norm = [
        p[..., 0] / torch.clamp(p[..., 0].mean(dim=(1, 2), keepdim=True),
                                min=1e-6)
        for p in inv_depths
    ]
    img_gx = torch.abs(image_pl[..., :-1] - image_pl[..., 1:])
    img_gy = torch.abs(image_pl[:, :, :-1, :] - image_pl[:, :, 1:, :])
    weights_x = torch.exp(-img_gx.mean(dim=1))
    weights_y = torch.exp(-img_gy.mean(dim=1))
    mask_x = mask[:, :, :-1]
    mask_y = mask[:, :-1, :]
    msum_x = torch.clamp(reduce_(mask_x.sum()), min=1.0)
    msum_y = torch.clamp(reduce_(mask_y.sum()), min=1.0)

    def smooth_scale(d: torch.Tensor) -> torch.Tensor:
        sx = (torch.abs((d[:, :, :-1] - d[:, :, 1:]) * weights_x)
              * mask_x).sum()
        sy = (torch.abs((d[:, :-1, :] - d[:, 1:, :]) * weights_y)
              * mask_y).sum()
        return all_sum(sx) / msum_x + all_sum(sy) / msum_y

    smoothness_loss = sum(smooth_scale(inv_norm[i]) / 2 ** i
                          for i in range(n)) / n
    return {
        "loss_photometric": photometric_loss * photometric_loss_weight,
        "loss_smoothness": smoothness_loss * smoothing_loss_weight,
    }
