"""Depth post-processing: surface normals, the DGC metric scale, and the
rescale with the class filter that the evaluation loop runs.

Port of ``mgnet_tpu/postprocessing/depth.py:28-205``: surface normals from
four cross products of the 8-neighbourhood (in planar form), the ground
mask (road class, or normals within 5 degrees of vertical), the camera
height of each ground pixel, its median, and scale = real height / median;
``depth_postprocess`` unprojects through ``Camera.reconstruct``, rescales
depth and points by that scale, and sets the pixels of the filtered
panoptic ids to 0 in depth and NaN in the points. The fused frame
(``inference/fused.py``) inlines the same steps.

``_masked_median`` is torch.median's lower-middle element over the masked
values, k = (count - 1) // 2, and +inf for an empty mask. The JAX package
finds it by a 32-step bisection over the float bit patterns (``:89-131``);
this port sorts and takes element k, which gives the same value.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from mgnet_tpu_torch.geometry.camera import Camera

__all__ = ["surface_normals", "dgc_scale_factor", "depth_postprocess"]


def _normalize3(x, y, z, eps: float = 1e-12):
    inv = torch.rsqrt(x * x + y * y + z * z + eps)
    return x * inv, y * inv, z * inv


def _cross3(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _surface_normals_planar(px, py, pz, nei: int = 1):
    """surface_normals on coordinate planes [B, H, W] each."""
    def shifts(p):
        c = p[:, nei:-nei, nei:-nei]
        return (
            p[:, nei:-nei, : -2 * nei] - c,       # x0
            p[:, : -2 * nei, nei:-nei] - c,       # y0
            p[:, nei:-nei, 2 * nei:] - c,         # x1
            p[:, 2 * nei:, nei:-nei] - c,         # y1
            p[:, : -2 * nei, : -2 * nei] - c,     # x0y0
            p[:, 2 * nei:, : -2 * nei] - c,       # x0y1
            p[:, : -2 * nei, 2 * nei:] - c,       # x1y0
            p[:, 2 * nei:, 2 * nei:] - c,         # x1y1
        )

    sx, sy, sz = shifts(px), shifts(py), shifts(pz)
    nx = ny = nz = 0.0
    for a, b in ((0, 1), (2, 3), (4, 5), (6, 7)):
        cx, cy, cz = _normalize3(
            *_cross3(sx[a], sy[a], sz[a], sx[b], sy[b], sz[b]))
        nx, ny, nz = nx + cx, ny + cy, nz + cz
    nx, ny, nz = _normalize3(nx / 4.0, ny / 4.0, nz / 4.0)

    def edge_pad(n):
        return F.pad(n[:, None], (nei, nei, nei, nei), mode="replicate")[:, 0]

    return edge_pad(nx), edge_pad(ny), edge_pad(nz)


def surface_normals(points: torch.Tensor, nei: int = 1) -> torch.Tensor:
    """Per-pixel unit normals [B, H, W, 3] of camera-frame points
    [B, H, W, 3], replicate-padded at the border."""
    n = _surface_normals_planar(points[..., 0], points[..., 1],
                                points[..., 2], nei=nei)
    return torch.stack(n, dim=-1)


def _masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower-middle masked element of each batch row: values, mask
    [B, ...] -> [B] f32 (+inf where the mask is empty)."""
    b = values.shape[0]
    v = values.reshape(b, -1).float()
    m = mask.reshape(b, -1)
    # masked-out entries sort last (NaN sorts after +inf)
    ordered, _ = torch.sort(torch.where(m, v, float("nan")), dim=1)
    count = m.sum(dim=1)
    k = torch.clamp((count - 1) // 2, min=0)
    med = torch.gather(ordered, 1, k[:, None])[:, 0]
    return torch.where(count > 0, med, float("inf"))


def dgc_scale_factor(points: torch.Tensor, real_camera_height,
                     ground_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Dynamic-Ground-Constraint scale [B]: real height / median height.

    Args:
        points: [B, H, W, 3] camera-frame points (unscaled).
        real_camera_height: [B] or scalar metric mounting height.
        ground_mask: [B, H, W] bool, or None to derive it from normals.
    """
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    nx, ny, nz = _surface_normals_planar(px, py, pz)
    if ground_mask is None:
        thr = math.cos(math.radians(5.0))
        norm = torch.sqrt(nx * nx + ny * ny + nz * nz + 1e-12)
        cos_sim = ny / torch.clamp(norm, min=1e-6)
        ground_mask = ((cos_sim > thr) | (cos_sim < -thr)) & (py > 0)
    heights = torch.abs(px * nx + py * ny + pz * nz)
    med = torch.clamp(_masked_median(heights, ground_mask), min=1e-6)
    real = torch.as_tensor(real_camera_height, dtype=points.dtype,
                           device=points.device).reshape(-1)
    return real / med


def depth_postprocess(
    depth: torch.Tensor,
    camera_matrix: Optional[torch.Tensor] = None,
    real_camera_height: Optional[torch.Tensor] = None,
    panoptic_seg: Optional[torch.Tensor] = None,
    *,
    use_dgc_scaling: bool = True,
    road_class_id: int = -1,
    filter_class_ids: Sequence[int] = (),
):
    """Metric-rescale a depth prediction and unproject a point cloud.

    Args:
        depth: [B, H, W, 1] predicted depth.
        camera_matrix: [B, 3, 3] intrinsics (required for DGC).
        real_camera_height: [B] metric camera height (required for DGC).
        panoptic_seg: [B, H, W] panoptic ids or None.

    Returns:
        (depth [B, H, W] f32, xyz points [B, H, W, 3] f32 or None)
    """
    depth = depth.float()
    points = None
    if use_dgc_scaling:
        if camera_matrix is None or real_camera_height is None:
            raise ValueError("DGC scaling needs the camera matrix and the "
                             "camera height")
        cam = Camera(camera_matrix.float())
        points = cam.reconstruct(depth, frame="c")
        ground_mask = None
        if panoptic_seg is not None and road_class_id != -1:
            ground_mask = panoptic_seg == road_class_id
        scale = dgc_scale_factor(points, real_camera_height,
                                 ground_mask).reshape(-1, 1, 1, 1)
        depth = depth * scale
        points = points * scale

    depth2d = depth[..., 0]
    if panoptic_seg is not None:
        for cid in filter_class_ids:
            m = panoptic_seg == cid
            depth2d = torch.where(m, 0.0, depth2d)
            if points is not None:
                points = torch.where(m[..., None], float("nan"), points)
    return depth2d, points
