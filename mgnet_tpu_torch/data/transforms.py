"""Geometric + photometric augmentations with camera-matrix co-augmentation.

A copy of ``mgnet_tpu/data/transforms.py`` without OpenCV and Pillow:
* resize-shortest-edge with 'choice' sampling and a max-size cap; focal
  lengths scale with the resize, the optical center uses the pixel-center
  (+0.5) convention;
* random absolute crop (the optical center shifts by the crop origin);
* random pad to crop size: image padded with the pixel mean (per axis, as
  the reference does), labels with a seg pad value, the reprojection mask
  zeroed on the padding;
* horizontal flip (x -> w - x for the optical center);
* color jitter with torchvision's PIL semantics, bit-exact to Pillow, in
  numpy: random order of brightness/contrast/saturation/hue with factors
  sampled once and re-applicable to the context frames.

``ResizeTransform`` resizes uint8 images through ``image_io``'s Pillow-exact
resample (BILINEAR for images, NEAREST for labels) and raises on any other
dtype. ``TransformList`` runs a resize followed by a crop as one windowed
resample: the same bytes, with only the crop's work.

Deterministic given a numpy Generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mgnet_tpu_torch.data import image_io

__all__ = [
    "Transform",
    "ResizeTransform",
    "CropTransform",
    "HFlipTransform",
    "PadTransform",
    "ColorJitterTransform",
    "TransformList",
    "build_train_transform_sampler",
    "resize_shortest_edge",
    "sample_color_jitter",
]


class Transform:
    """Deterministic transform applied consistently to image/seg/coords."""

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        return img

    def apply_segmentation(self, seg: np.ndarray) -> np.ndarray:
        return seg

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        return coords

    def apply_focal(self, focal: np.ndarray) -> np.ndarray:
        return focal

    def apply_reprojection_mask(self, mask: np.ndarray) -> np.ndarray:
        return mask


class TransformList(Transform):
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __iter__(self):
        return iter(self.transforms)

    def _apply(self, x, resample: str, method: str):
        """Each transform's ``method`` in order; a ResizeTransform directly
        followed by a CropTransform resamples only the crop's window."""
        i, ts = 0, self.transforms
        while i < len(ts):
            t = ts[i]
            nxt = ts[i + 1] if i + 1 < len(ts) else None
            if isinstance(t, ResizeTransform) and isinstance(
                    nxt, CropTransform):
                x = t.apply_window(x, resample,
                                   (nxt.y0, nxt.x0, nxt.h, nxt.w))
                i += 2
                continue
            x = getattr(t, method)(x)
            i += 1
        return x

    def apply_image(self, img):
        return self._apply(img, "bilinear", "apply_image")

    def apply_segmentation(self, seg):
        return self._apply(seg, "nearest", "apply_segmentation")

    def apply_coords(self, coords):
        for t in self.transforms:
            coords = t.apply_coords(coords)
        return coords

    def apply_focal(self, focal):
        for t in self.transforms:
            focal = t.apply_focal(focal)
        return focal

    def apply_reprojection_mask(self, mask):
        for t in self.transforms:
            mask = t.apply_reprojection_mask(mask)
        return mask


@dataclass
class ResizeTransform(Transform):
    """Pillow-semantics resize: BILINEAR (an antialiased triangle filter
    whose support widens with the downscale factor) for images, NEAREST for
    labels, as the reference's detectron2 ResizeTransform resizes uint8
    through ``PIL.Image.resize``; here through ``image_io``'s bit-exact
    resample. Another dtype raises unless the size is unchanged."""

    h: int
    w: int
    new_h: int
    new_w: int

    def apply_window(self, img, resample: str, window=None):
        """The ``resample`` ('bilinear' or 'nearest') resize of ``img``, or
        only its ``window`` (y0, x0, h, w), clipped to the result as a
        crop slice would be."""
        if window is not None:
            y0, x0, wh, ww = window
            wh = min(wh, self.new_h - y0)
            ww = min(ww, self.new_w - x0)
            window = (y0, x0, wh, ww)
        if (self.h, self.w) == (self.new_h, self.new_w):
            if window is None:
                return img
            y0, x0, wh, ww = window
            return img[y0:y0 + wh, x0:x0 + ww]
        if img.dtype != np.uint8:
            raise TypeError(f"ResizeTransform resizes uint8 images, got "
                            f"{img.dtype}")
        fn = (image_io.resize_bilinear if resample == "bilinear"
              else image_io.resize_nearest)
        return fn(img, self.new_h, self.new_w, window)

    def apply_image(self, img):
        return self.apply_window(img, "bilinear")

    def apply_segmentation(self, seg):
        return self.apply_window(seg, "nearest")

    def apply_coords(self, coords):
        # pixel-center convention for the optical center
        # (reference transform.py:122-127)
        coords = np.asarray(coords, np.float64).copy()
        coords[:, 0] = (coords[:, 0] + 0.5) * (self.new_w / self.w) - 0.5
        coords[:, 1] = (coords[:, 1] + 0.5) * (self.new_h / self.h) - 0.5
        return coords

    def apply_focal(self, focal):
        focal = np.asarray(focal, np.float64).copy()
        focal[:, 0] *= self.new_w / self.w
        focal[:, 1] *= self.new_h / self.h
        return focal


@dataclass
class CropTransform(Transform):
    x0: int
    y0: int
    w: int
    h: int

    def apply_image(self, img):
        return img[self.y0:self.y0 + self.h, self.x0:self.x0 + self.w]

    apply_segmentation = apply_image

    def apply_coords(self, coords):
        coords = np.asarray(coords, np.float64).copy()
        coords[:, 0] -= self.x0
        coords[:, 1] -= self.y0
        return coords


@dataclass
class HFlipTransform(Transform):
    width: int

    def apply_image(self, img):
        return np.ascontiguousarray(img[:, ::-1])

    apply_segmentation = apply_image

    def apply_coords(self, coords):
        coords = np.asarray(coords, np.float64).copy()
        coords[:, 0] = self.width - coords[:, 0]
        return coords


@dataclass
class PadTransform(Transform):
    x0: int
    y0: int
    x1: int
    y1: int
    pad_value: Tuple[float, ...] = (0.0, 0.0, 0.0)
    pad_value_seg: float = 0.0

    @property
    def _any(self):
        return self.x0 or self.x1 or self.y0 or self.y1

    def apply_image(self, img):
        """Reference-exact image padding, including its per-AXIS quirk.

        The reference feeds ``np.repeat(expand_dims(PIXEL_MEAN, 1), 2, 1)``
        — a (3, 2) array — as np.pad ``constant_values``
        (dataset_mapper.py:88-89 + fvcore PadTransform), which numpy reads
        as one constant PER AXIS, not per channel: y-borders fill with
        PIXEL_MEAN[0] in all channels, x-borders with PIXEL_MEAN[1]
        (x overwrites corners). Almost certainly intended as mean-COLOR
        padding, but parity means matching the actual behavior; the pad
        region is masked from every loss (seg pads to ignore, the
        reprojection mask zeroes borders) and the shipped configs never
        trigger it (min resize edge == crop size), so the only exposure is
        conv context. Bit-equality vs the transcription:
        tests/test_golden_mapper.py.
        """
        if not self._any:
            return img
        pads = ((self.y0, self.y1), (self.x0, self.x1), (0, 0))
        pv = np.repeat(
            np.expand_dims(np.asarray(self.pad_value, np.float64), 1),
            2, axis=1,
        )
        if img.ndim == 2:
            pads, pv = pads[:2], pv[:2]
        return np.pad(img, pads, mode="constant", constant_values=pv)

    def apply_segmentation(self, seg):
        if not self._any:
            return seg
        pads = ((self.y0, self.y1), (self.x0, self.x1))
        if seg.ndim == 3:
            pads = pads + ((0, 0),)
        return np.pad(
            seg, pads, mode="constant", constant_values=self.pad_value_seg
        )

    def apply_coords(self, coords):
        coords = np.asarray(coords, np.float64).copy()
        coords[:, 0] += self.x0
        coords[:, 1] += self.y0
        return coords

    def apply_reprojection_mask(self, mask):
        """Zero padded borders of an already padded-size mask.

        Parity: reference transform.py:80-87 — the mask is built from the
        post-augmentation label and only the pad borders are invalidated.
        """
        if not self._any:
            return mask
        keep = np.zeros_like(mask, dtype=bool)
        keep[self.y0:mask.shape[0] - self.y1,
             self.x0:mask.shape[1] - self.x1] = True
        return mask & keep


# ---------------------------------------------------------------------------
# Color jitter — bit-exact torchvision-PIL semantics over uint8 RGB numpy.
#
# The reference jitters through torchvision.transforms.functional on PIL
# Images (reference transform.py:208-221), i.e. PIL ImageEnhance +
# convert("HSV"). Pillow's Blend.c computes ``deg + alpha*(img - deg)`` in
# float32 and truncates to int (NOT round-half-up), its "L" conversion is
# the integer luma ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``, and
# ImageEnhance.Contrast uses ``int(mean(L) + 0.5)`` as the scalar
# degenerate. All three blend ops below replicate that bit-exactly
# (verified over every uint8 value and random images,
# tests/test_golden_mapper.py); brightness/contrast stay 256-entry LUTs
# (per-VALUE ops — one gather per pixel instead of a full-res f32 chain,
# the mapper hot spot per BENCH_NOTES §Data pipeline). Hue goes through
# PIL's own HSV roundtrip — exactly the torchvision PIL path, including
# its quantization when the shift is 0.
# ---------------------------------------------------------------------------


def _blend_lut(factor: float, degenerate: float) -> np.ndarray:
    """256-entry LUT of Pillow's Blend.c: f32 math, truncating int cast."""
    v = np.arange(256, dtype=np.float32)
    deg = np.float32(degenerate)
    out = deg + np.float32(factor) * (v - deg)
    return np.clip(out, 0, 255).astype(np.uint8)  # astype truncates like C


def _apply_lut(img: np.ndarray, lut: np.ndarray) -> np.ndarray:
    return lut[img]


def _adjust_brightness(img, factor):
    if img.dtype != np.uint8:  # LUT indexing assumes uint8 values
        return np.clip(factor * img.astype(np.float32), 0, 255).astype(
            img.dtype)
    return _apply_lut(img, _blend_lut(factor, 0.0))


def _gray_l(img: np.ndarray) -> np.ndarray:
    """PIL convert("L") integer luma (Pillow convert.c L24 macro)."""
    arr = img.astype(np.uint32)
    return ((arr[..., 0] * 19595 + arr[..., 1] * 38470
             + arr[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def _adjust_contrast(img, factor):
    if img.dtype != np.uint8:  # LUT indexing assumes uint8 values
        mean = float(img.astype(np.float32).mean())
        return np.clip(
            factor * img.astype(np.float32) + (1.0 - factor) * mean,
            0, 255).astype(img.dtype)
    # ImageEnhance.Contrast: int(ImageStat mean of the L image + 0.5)
    mean = int(float(_gray_l(img).mean(dtype=np.float64)) + 0.5)
    return _apply_lut(img, _blend_lut(factor, mean))


def _adjust_saturation(img, factor):
    # ImageEnhance.Color: per-pixel blend with the L gray — not a value
    # LUT; Pillow's truncating f32 blend, broadcast over channels.
    gray = _gray_l(img).astype(np.float32)[..., None]
    out = gray + np.float32(factor) * (img.astype(np.float32) - gray)
    return np.clip(out, 0, 255).astype(np.uint8)


def _rgb2hsv_pil(img: np.ndarray) -> np.ndarray:
    """Pillow convert("HSV") bit-exactly, vectorized.

    Pillow's Convert.c follows colorsys in C floats; the binding rounding
    sites (derived empirically, then verified over ALL 2^24 RGB inputs —
    tests/test_golden_mapper.py has the sampled CI check) are:
    the (maxc-x)/cr ratios and the maxc==r subtraction are f32; the
    maxc==g/b branches promote through the C double literals 2.0/4.0 and
    round back to f32 on store; /6 and the mod-1 wrap are f32; the final
    *255 truncates. S is exact integer math: 255*cr//maxc.
    """
    r, g, b = (img[..., i].astype(np.float32) for i in range(3))
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    cr = maxc - minc
    gray = cr == 0
    crs = np.where(gray, np.float32(1), cr)
    rc = (maxc - r) / crs
    gc = (maxc - g) / crs
    bc = (maxc - b) / crs
    h = np.where(
        maxc == r, bc - gc,
        np.where(maxc == g,
                 (2.0 + rc.astype(np.float64) - bc).astype(np.float32),
                 (4.0 + gc.astype(np.float64) - rc).astype(np.float32)))
    h = (h / np.float32(6.0)) % np.float32(1.0)
    uh = (h.astype(np.float64) * 255.0).astype(np.uint8)
    s = (255 * cr.astype(np.uint32)
         // np.maximum(maxc, 1).astype(np.uint32)).astype(np.uint8)
    zero = np.uint8(0)
    return np.stack([np.where(gray, zero, uh), np.where(gray, zero, s),
                     maxc.astype(np.uint8)], axis=-1)


def _hsv2rgb_pil(hsv: np.ndarray) -> np.ndarray:
    """Pillow Image.merge("HSV", ...).convert("RGB") bit-exactly,
    vectorized: colorsys hsv_to_rgb in C doubles with round-half-up on
    p/q/t (verified over ALL 2^24 HSV inputs; sampled check in CI)."""
    uh = hsv[..., 0].astype(np.float64)
    us = hsv[..., 1]
    uv = hsv[..., 2]
    h6 = (uh / 255.0) * 6.0
    i = h6.astype(np.int32)
    f = h6 - i
    s = us.astype(np.float64) / 255.0
    v = uv.astype(np.float64)
    p = (v * (1.0 - s) + 0.5).astype(np.uint8)
    q = (v * (1.0 - s * f) + 0.5).astype(np.uint8)
    t = (v * (1.0 - s * (1.0 - f)) + 0.5).astype(np.uint8)
    im = i % 6
    sel = [im == k for k in range(6)]
    r = np.select(sel, [uv, q, p, p, t, uv])
    g = np.select(sel, [t, uv, uv, q, p, p])
    b = np.select(sel, [p, p, t, uv, uv, q])
    gray = us == 0
    out = np.stack([np.where(gray, uv, r), np.where(gray, uv, g),
                    np.where(gray, uv, b)], axis=-1)
    return out.astype(np.uint8)


def _adjust_hue(img, factor):
    """torchvision F_pil.adjust_hue: PIL HSV roundtrip + uint8-wrap shift.

    The shift is ``np.uint8(factor * 255)`` under numpy 1.x semantics:
    truncate toward zero, then wrap mod 256 (negative factors wrap high).
    Applied even when the shift lands on 0 — the RGB->HSV->RGB roundtrip
    itself quantizes, and the reference inherits that.
    """
    shift = int(np.trunc(np.float64(factor) * 255.0)) % 256
    hsv = _rgb2hsv_pil(img)
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + shift).astype(np.uint8)
    return _hsv2rgb_pil(hsv)


@dataclass
class ColorJitterTransform(Transform):
    """Re-applicable jitter: the same sampled factors/order are used for the
    current and context frames (reference dataset_mapper.py:162-208)."""

    fn_order: Tuple[int, ...] = (0, 1, 2, 3)
    brightness: Optional[float] = None
    contrast: Optional[float] = None
    saturation: Optional[float] = None
    hue: Optional[float] = None

    def apply_image(self, img):
        out = img
        for fn in self.fn_order:
            if fn == 0 and self.brightness is not None:
                out = _adjust_brightness(out, self.brightness)
            elif fn == 1 and self.contrast is not None:
                out = _adjust_contrast(out, self.contrast)
            elif fn == 2 and self.saturation is not None:
                out = _adjust_saturation(out, self.saturation)
            elif fn == 3 and self.hue is not None:
                out = _adjust_hue(out, self.hue)
        return out


def sample_color_jitter(rng: np.random.Generator, brightness=0.2, contrast=0.2,
                        saturation=0.2, hue=0.05) -> ColorJitterTransform:
    def rng_range(v, center=1.0):
        lo, hi = max(0.0, center - v), center + v
        return float(rng.uniform(lo, hi))

    return ColorJitterTransform(
        fn_order=tuple(rng.permutation(4).tolist()),
        brightness=rng_range(brightness) if brightness else None,
        contrast=rng_range(contrast) if contrast else None,
        saturation=rng_range(saturation) if saturation else None,
        hue=float(rng.uniform(-hue, hue)) if hue else None,
    )


def resize_shortest_edge(h: int, w: int, short_sizes: Sequence[int],
                         max_size: int, rng: np.random.Generator
                         ) -> ResizeTransform:
    """Sample a shortest-edge resize ('choice' sampling, max-size cap).

    Parity: reference transform.py:96-119 / detectron2 ResizeShortestEdge.
    """
    size = int(rng.choice(list(short_sizes)))
    if size == 0:
        return ResizeTransform(h, w, h, w)
    scale = size / min(h, w)
    if h < w:
        newh, neww = size, scale * w
    else:
        newh, neww = scale * h, size
    if max(newh, neww) > max_size:
        s = max_size / max(newh, neww)
        newh, neww = newh * s, neww * s
    return ResizeTransform(h, w, int(newh + 0.5), int(neww + 0.5))


def build_train_transform_sampler(cfg):
    """Return fn(rng, image_shape) -> TransformList of geometric transforms.

    Matches the reference augmentation chain order: resize -> random crop ->
    random pad to crop size -> random hflip (dataset_mapper.py:72-90).
    """
    inp = cfg.INPUT
    pixel_mean = tuple(cfg.MODEL.PIXEL_MEAN)

    def sampler(rng: np.random.Generator, shape) -> TransformList:
        h, w = shape[:2]
        tfs: List[Transform] = []
        t = resize_shortest_edge(
            h, w, inp.MIN_SIZE_TRAIN, inp.MAX_SIZE_TRAIN, rng
        )
        tfs.append(t)
        cur_h, cur_w = t.new_h, t.new_w
        if inp.CROP.ENABLED:
            ch, cw = inp.CROP.SIZE
            crop_h, crop_w = min(ch, cur_h), min(cw, cur_w)
            y0 = int(rng.integers(0, cur_h - crop_h + 1))
            x0 = int(rng.integers(0, cur_w - crop_w + 1))
            tfs.append(CropTransform(x0, y0, crop_w, crop_h))
            cur_h, cur_w = crop_h, crop_w
            if inp.CROP.RANDOM_PAD_TO_CROP_SIZE:
                pad_h, pad_w = max(0, ch - cur_h), max(0, cw - cur_w)
                py0 = int(rng.integers(0, pad_h + 1))
                px0 = int(rng.integers(0, pad_w + 1))
                tfs.append(PadTransform(
                    px0, py0, pad_w - px0, pad_h - py0,
                    pad_value=pixel_mean, pad_value_seg=0,
                ))
                cur_h, cur_w = ch, cw
        if cfg.INPUT.RANDOM_FLIP == "horizontal" and rng.random() < 0.5:
            tfs.append(HFlipTransform(cur_w))
        return TransformList(tfs)

    return sampler
