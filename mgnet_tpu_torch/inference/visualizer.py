"""Visualization of panoptic, instance and depth predictions (numpy).

A copy of ``mgnet_tpu/inference/visualizer.py``: the panoptic overlay with
category colours (instance colours jittered from a fixed seed), offset
directions on a cyclic colormap weighted by the center heatmap, and depth
on a reversed-plasma colormap clipped at 80 m. Two things the JAX module
takes from OpenCV and Pillow are the port's own: the overlay's resize of
an image of another size is ``resize_linear_u8``, which gives what
``cv2.resize(..., INTER_LINEAR)`` gives for uint8 images, and the PNGs are
written by ``data.image_io.write_png``.
"""

from __future__ import annotations

import colorsys
from typing import Optional

import numpy as np

from mgnet_tpu_torch.data.image_io import write_png

__all__ = ["Visualizer", "resize_linear_u8"]

_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS


def _linear_taps(in_size: int, out_size: int, clamp: bool):
    """Source indices and fixed-point weights (scaled by 2^11, rounded half
    to even) of each output position, with OpenCV's half-pixel centers
    ``f = (d + 0.5) * in / out - 0.5`` in float32. Along x a tap outside
    the image takes the edge pixel at full weight (``clamp``); along y the
    weights stay and only the rows are clipped to the image."""
    scale = 1.0 / (np.float64(out_size) / in_size)
    f = ((np.arange(out_size, dtype=np.float64) + 0.5) * scale
         - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    if clamp:
        edge = (s < 0) | (s >= in_size - 1)
        f[edge] = 0
        s = np.clip(s, 0, in_size - 1)
    one = np.float32(1 << _COEF_BITS)
    w0 = np.round((np.float32(1) - f) * one).astype(np.int64)
    w1 = np.round(f * one).astype(np.int64)
    return (np.clip(s, 0, in_size - 1), np.clip(s + 1, 0, in_size - 1),
            w0, w1)


def resize_linear_u8(image: np.ndarray, out_h: int,
                     out_w: int) -> np.ndarray:
    """Bilinear resize of a uint8 [H, W] or [H, W, C] image as OpenCV's
    ``cv2.resize(image, (out_w, out_h), interpolation=INTER_LINEAR)``
    computes it: a horizontal pass in integers scaled by 2^11, then the
    vertical pass in the form of its vector code, each row product shifted
    right by 4 and multiplied by the 2^11 weight keeping the high 16 bits,
    the two summed and rounded by (s + 2) >> 2."""
    h, w = image.shape[:2]
    x0, x1, a0, a1 = _linear_taps(w, out_w, clamp=True)
    y0, y1, b0, b1 = _linear_taps(h, out_h, clamp=False)
    src = image.astype(np.int64)
    shape = (-1,) + (1,) * (image.ndim - 2)
    rows = src[:, x0] * a0.reshape(shape) + src[:, x1] * a1.reshape(shape)
    shape = (-1, 1) + (1,) * (image.ndim - 2)
    out = (((rows[y0] >> 4) * b0.reshape(shape)) >> 16) \
        + (((rows[y1] >> 4) * b1.reshape(shape)) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def _plasma_r(x: np.ndarray) -> np.ndarray:
    """Approximate plasma_r colormap over x in [0, 1] -> uint8 RGB."""
    x = 1.0 - np.clip(x, 0.0, 1.0)  # reversed
    # piecewise-linear approximation of matplotlib plasma anchor colors
    anchors = np.array([
        [13, 8, 135], [84, 2, 163], [139, 10, 165], [185, 50, 137],
        [219, 92, 104], [244, 136, 73], [254, 188, 43], [240, 249, 33],
    ], np.float32)
    pos = np.linspace(0, 1, len(anchors))
    r = np.interp(x, pos, anchors[:, 0])
    g = np.interp(x, pos, anchors[:, 1])
    b = np.interp(x, pos, anchors[:, 2])
    return np.stack([r, g, b], -1).astype(np.uint8)


def _twilight(angle: np.ndarray) -> np.ndarray:
    """Cyclic colormap for offset directions: angle in [-pi, pi]."""
    h = (angle + np.pi) / (2 * np.pi)
    flat = h.reshape(-1)
    rgb = np.array([colorsys.hsv_to_rgb(v, 0.8, 0.9) for v in flat])
    return (rgb.reshape(h.shape + (3,)) * 255).astype(np.uint8)


class Visualizer:
    def __init__(self, metadata, label_divisor: int = 1000):
        self.meta = metadata
        self.label_divisor = metadata.get("label_divisor", label_divisor) \
            if hasattr(metadata, "get") else label_divisor
        self.colors = {
            c["trainId"]: c["color"] for c in metadata.categories
        }

    def panoptic_rgb(self, panoptic: np.ndarray,
                     image: Optional[np.ndarray] = None,
                     alpha: float = 0.5) -> np.ndarray:
        h, w = panoptic.shape
        if image is not None and image.shape[:2] != (h, w):
            image = resize_linear_u8(image, h, w)
        out = np.zeros((h, w, 3), np.float32)
        rng = np.random.RandomState(42)
        for pid in np.unique(panoptic):
            mask = panoptic == pid
            if pid < 0:
                color = (0, 0, 0)
            else:
                cls = int(pid) // self.label_divisor
                color = np.asarray(self.colors.get(cls, (128, 128, 128)),
                                   np.float32)
                if pid % self.label_divisor > 0:
                    # jitter instance colors like the reference visualizer
                    color = np.clip(color + rng.uniform(-40, 40, 3), 0, 255)
            out[mask] = color
        if image is not None:
            out = alpha * out + (1 - alpha) * image.astype(np.float32)
        return out.astype(np.uint8)

    def instance_heatmap_rgb(self, center: np.ndarray,
                             offset: np.ndarray) -> np.ndarray:
        """Offset-direction hue + center intensity overlay
        (reference draw_instance_heatmaps)."""
        angle = np.arctan2(offset[..., 0], offset[..., 1])
        rgb = _twilight(angle).astype(np.float32)
        mag = np.clip(center, 0, 1)[..., None]
        return (rgb * (0.3 + 0.7 * mag)).astype(np.uint8)

    def depth_rgb(self, depth: np.ndarray, max_depth: float = 80.0
                  ) -> np.ndarray:
        return _plasma_r(np.clip(depth, 0, max_depth) / max_depth)

    # -- file savers --------------------------------------------------------
    def _save(self, path: str, rgb: np.ndarray):
        write_png(path, rgb)

    def save_panoptic(self, path, image, panoptic):
        self._save(path, self.panoptic_rgb(panoptic, image))

    def save_instance_heatmaps(self, path, center, offset):
        self._save(path, self.instance_heatmap_rgb(center, offset))

    def save_depth(self, path, depth):
        self._save(path, self.depth_rgb(depth))
