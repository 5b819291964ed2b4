"""A Gaussian blur in numpy, equal to ``cv2.GaussianBlur(x, (0, 0), sigma)``
on float32 images.

The card's machine has no OpenCV, and the depth validation's texture
(``tools/validate_depth_overfit.py:_texture``) blurs noise with it. So this
is OpenCV's recipe for a float32 image with the kernel size left to it:
``round(8 sigma + 1) | 1`` taps of exp(-x^2 / (2 sigma^2)), normalised in
float64 and rounded to float32 (``getGaussianKernel``); a horizontal then a
vertical pass, the intermediate rounded to float32 (``sepFilter2D``); and
the ``BORDER_REFLECT_101`` border (``... c b | a b c ... | b a ...``),
folded as many times as a kernel wider than the image needs
(``borderInterpolate``). Sums run in float64, so a value may differ from
OpenCV's float32 sums in its last bits.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gaussian_blur", "gaussian_kernel", "reflect_101"]


def gaussian_kernel(sigma: float) -> np.ndarray:
    """OpenCV's float32 Gaussian taps for ``sigma`` and ksize (0, 0)."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) / 2
    taps = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (taps / taps.sum()).astype(np.float32)


def reflect_101(index: np.ndarray, n: int) -> np.ndarray:
    """Map indices outside [0, n) into it by reflection about the edge
    pixels (``BORDER_REFLECT_101``), folding as often as needed."""
    index = np.asarray(index).copy()
    if n == 1:
        return np.zeros_like(index)
    while True:
        low, high = index < 0, index >= n
        if not (low.any() or high.any()):
            return index
        index[low] = -index[low]
        index[high] = 2 * n - 2 - index[high]


def _pass(img: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    n, r = img.shape[axis], len(taps) // 2
    padded = np.take(img.astype(np.float64),
                     reflect_101(np.arange(-r, n + r), n), axis=axis)
    out = np.zeros(img.shape, np.float64)
    for i, t in enumerate(taps.astype(np.float64)):
        out += t * np.take(padded, np.arange(i, i + n), axis=axis)
    return out.astype(np.float32)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """``img`` [H, W] or [H, W, C] float32 blurred by ``sigma`` on both
    axes, each channel on its own, as float32."""
    taps = gaussian_kernel(sigma)
    return _pass(_pass(np.asarray(img, np.float32), taps, 1), taps, 0)
