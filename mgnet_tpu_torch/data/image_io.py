"""PNG decode and encode, and Pillow-exact resampling, without Pillow.

The port's counterpart of ``mgnet_tpu/data/native.py`` (libpng or Pillow
decode, cv2-style resize) and of the ``PIL.Image.resize`` calls of
``mgnet_tpu/data/transforms.py``, for a machine that has neither Pillow,
OpenCV nor the libpng headers. Every image the datasets use is a PNG.

* ``read_png``: parses the chunks, inflates IDAT with the standard
  library's ``zlib`` and undoes the row filters in C++
  (``csrc/image_ops.cpp``; Paeth is sequential along a row, so numpy cannot
  vectorise it). 8-bit grey, RGB and RGBA come back as RGB uint8 [H, W, 3],
  as ``Image.open(p).convert("RGB")`` gives them (grey repeated, alpha
  dropped); 16-bit grey as uint16 [H, W]. Interlaced, palette and other
  PNGs raise ``ValueError`` with the file name. The CRC of every chunk but
  IDAT is checked; IDAT's bytes are covered by the zlib stream's own
  Adler-32.
* ``write_png``: filter 0 on every row and ``zlib.compress`` at level 1.
* ``resize_bilinear`` / ``resize_nearest``: ``Image.resize`` with BILINEAR
  and NEAREST, bit for bit, on uint8 [H, W] ("L") or [H, W, 3] ("RGB"),
  in C++; with ``window=(y0, x0, h, w)`` only that window of the result is
  computed. (Pillow premultiplies alpha before a filter, so RGBA is not
  taken.)

The C++ library is built with g++ at the first call (``ops/_build.py``
``build_host``) and loaded with ``ctypes``, which releases the interpreter
lock during each call, so the loader's threads decode and resample in
parallel. A failed build or load raises: nothing falls back.

``png_unfilter_reference``, ``resize_bilinear_reference`` and
``resize_nearest_reference`` are the plain numpy versions of the C++
routines, and ``png_filter_reference`` applies the five filters; the tests
and ``chip_smoke.py`` hold the C++ to them.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
import threading
import zlib
from typing import Optional, Tuple

import numpy as np

from mgnet_tpu_torch.ops import _build

__all__ = ["load_host_library", "png_filter_reference",
           "png_unfilter", "png_unfilter_reference", "read_png",
           "resize_bilinear", "resize_bilinear_reference", "resize_nearest",
           "resize_nearest_reference", "write_png"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (colour type, bit depth) -> (samples per pixel, bytes per pixel)
_FORMATS = {(0, 8): (1, 1), (2, 8): (3, 3), (6, 8): (4, 4), (0, 16): (1, 2)}
_COLOUR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey+alpha",
                 6: "RGBA"}
PRECISION_BITS = 32 - 8 - 2
_LOAD_LOCK = threading.Lock()


@functools.cache
def _load() -> ctypes.CDLL:
    path, _ = _build.build_host()
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mg_png_unfilter.argtypes = [vp, vp, i32, i64, i32]
    resample = [vp, i32, i32, i32, vp, *[i32] * 6]
    lib.mg_resample_bilinear_u8.argtypes = resample
    lib.mg_resample_nearest_u8.argtypes = resample
    for fn in (lib.mg_png_unfilter, lib.mg_resample_bilinear_u8,
               lib.mg_resample_nearest_u8):
        fn.restype = ctypes.c_int
    return lib


def load_host_library() -> ctypes.CDLL:
    """Build (if needed) and load the host library, once per process, from
    any number of threads."""
    with _LOAD_LOCK:
        return _load()


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def png_unfilter(filtered, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of an inflated PNG stream (``h`` rows of a
    filter-type byte and ``stride`` bytes) -> uint8 [h, stride]."""
    src = np.frombuffer(filtered, np.uint8)
    if src.size != h * (stride + 1):
        raise ValueError(f"filtered stream of {src.size} bytes, expected "
                         f"{h} x (1 + {stride})")
    out = np.empty((h, stride), np.uint8)
    rc = load_host_library().mg_png_unfilter(_ptr(src), _ptr(out), h, stride,
                                             bpp)
    if rc != 0:
        raise ValueError(f"unknown PNG filter type in row {-rc - 1}")
    return out


def read_png(path) -> np.ndarray:
    """Decode the PNG file at ``path`` (see the module docstring for the
    formats); errors name the file."""
    name = str(path)
    with open(path, "rb") as f:
        view = memoryview(f.read())
    if bytes(view[:8]) != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while True:
        if pos + 12 > len(view):
            raise ValueError(f"{name}: truncated PNG (no IEND chunk)")
        length, ctype = struct.unpack(">I4s", view[pos:pos + 8])
        body = view[pos + 8:pos + 8 + length]
        crc = view[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated {ctype!r} chunk")
        pos += 12 + length
        if ctype == b"IDAT":
            idat.append(body)
            continue
        if zlib.crc32(body, zlib.crc32(ctype)) != int.from_bytes(crc, "big"):
            raise ValueError(f"{name}: CRC mismatch in the {ctype!r} chunk")
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if interlace:
        raise ValueError(f"{name}: interlaced PNG is not supported")
    if (colour, depth) not in _FORMATS or compression or filtering:
        raise ValueError(
            f"{name}: unsupported PNG ({depth}-bit "
            f"{_COLOUR_NAMES.get(colour, f'colour type {colour}')}); "
            "supported: 8-bit grey, RGB and RGBA, 16-bit grey")
    samples, bpp = _FORMATS[colour, depth]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt image data: {e}") from e
    if len(raw) != h * (1 + w * bpp):
        raise ValueError(f"{name}: {len(raw)} bytes of image data, expected "
                         f"{h * (1 + w * bpp)}")
    try:
        rows = png_unfilter(raw, h, w * bpp, bpp)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from e
    if depth == 16:
        return rows.view(">u2").reshape(h, w).astype(np.uint16)
    pixels = rows.reshape(h, w, samples)
    if samples == 1:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(body, zlib.crc32(ctype))))


def write_png(path, arr: np.ndarray) -> None:
    """Write uint8 [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4] (RGBA), or
    uint16 [H, W] (16-bit grey), as a PNG with filter 0 on every row and
    zlib level 1 (fast, larger files)."""
    arr = np.asarray(arr)
    formats = {(np.uint8, 2, 1): (0, 8), (np.uint8, 3, 3): (2, 8),
               (np.uint8, 3, 4): (6, 8), (np.uint16, 2, 1): (0, 16)}
    key = (arr.dtype.type, arr.ndim, arr.shape[2] if arr.ndim == 3 else 1)
    if key not in formats:
        raise ValueError(f"write_png: no PNG format for {arr.dtype} "
                         f"{arr.shape}")
    colour, depth = formats[key]
    h, w = arr.shape[:2]
    data = arr.astype(">u2") if depth == 16 else arr
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(h, -1)
    filtered = np.zeros((h, 1 + rows.shape[1]), np.uint8)
    filtered[:, 1:] = rows
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(filtered, 1))
                + _chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png_filter_reference(rows: np.ndarray, bpp: int,
                         types) -> np.ndarray:
    """Filter uint8 rows [h, stride] with the filter ``types[y]`` (0-4) on
    row y (PNG spec section 9) -> the h x (1 + stride) stream as uint8."""
    x = rows.astype(np.int32)
    h, stride = x.shape
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    up_left = np.zeros_like(x)
    up_left[1:, bpp:] = x[:-1, :-bpp]
    predictors = (np.zeros_like(x), left, up, (left + up) >> 1,
                  _paeth(left, up, up_left))
    out = np.empty((h, 1 + stride), np.uint8)
    for y, t in enumerate(types):
        out[y, 0] = t
        out[y, 1:] = (x[y] - predictors[t][y]) % 256
    return out


def png_unfilter_reference(filtered, h: int, stride: int,
                           bpp: int) -> np.ndarray:
    """Plain numpy version of ``png_unfilter`` (a Python loop over pixels
    for Average and Paeth: for small images)."""
    src = np.frombuffer(filtered, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    zero = np.zeros(stride, np.int32)
    for y in range(h):
        t, f = int(src[y, 0]), src[y, 1:].astype(np.int32)
        up = out[y - 1] if y else zero
        if t == 0:
            out[y] = f
        elif t == 1:
            out[y] = np.cumsum(f.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif t == 2:
            out[y] = (f + up) % 256
        elif t in (3, 4):
            for i in range(0, stride, bpp):
                a = out[y, i - bpp:i] if i else zero[:bpp]
                b = up[i:i + bpp]
                if t == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp:i] if i else zero[:bpp]
                    pred = _paeth(a, b, c)
                out[y, i:i + bpp] = (f[i:i + bpp] + pred) % 256
        else:
            raise ValueError(f"unknown PNG filter type in row {y}")
    return out.astype(np.uint8)


# ---------------------------------------------------------------------------
# Pillow-exact resampling
# ---------------------------------------------------------------------------


def _resample(fn: str, img: np.ndarray, out_h: int, out_w: int,
              window: Optional[Tuple[int, int, int, int]]) -> np.ndarray:
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise TypeError(f"{fn}: takes uint8 [H, W] or [H, W, 3], got "
                        f"{img.dtype} {img.shape}")
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    y0, x0, wh, ww = window if window is not None else (0, 0, out_h, out_w)
    out = np.empty((wh, ww) + img.shape[2:], np.uint8)
    rc = getattr(load_host_library(), fn)(
        _ptr(img), h, w, c, _ptr(out), out_h, out_w, y0, x0, wh, ww)
    if rc != 0:
        raise ValueError(f"{fn}: bad sizes: {img.shape} -> ({out_h}, "
                         f"{out_w}), window {window}")
    return out


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int,
                    window: Optional[Tuple[int, int, int, int]] = None
                    ) -> np.ndarray:
    """``Image.fromarray(img).resize((out_w, out_h), Image.BILINEAR)`` bit
    for bit; with ``window=(y0, x0, h, w)`` only that window of it."""
    return _resample("mg_resample_bilinear_u8", img, out_h, out_w, window)


def resize_nearest(img: np.ndarray, out_h: int, out_w: int,
                   window: Optional[Tuple[int, int, int, int]] = None
                   ) -> np.ndarray:
    """``Image.fromarray(img).resize((out_w, out_h), Image.NEAREST)`` bit
    for bit; with ``window`` only that window of it."""
    return _resample("mg_resample_nearest_u8", img, out_h, out_w, window)


def _coefficients_reference(in_size: int, out_size: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for BILINEAR:
    (first input index, tap count, int coefficients [out, ksize])."""
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = 0.0 + (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    first = np.maximum((center - support + 0.5).astype(np.int64), 0)
    count = np.minimum((center + support + 0.5).astype(np.int64),
                       in_size) - first
    k = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for t in range(ksize):
        x = np.abs(((t + first) - center + 0.5) * ss)
        w_t = np.where((t < count) & (x < 1.0), 1.0 - x, 0.0)
        k[:, t] = w_t
        ww = ww + w_t
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None],
                 k)
    v = k * float(1 << PRECISION_BITS)
    kint = np.where(k < 0, -0.5 + v, 0.5 + v).astype(np.int32)
    return first, count, kint


def _pass_reference(img: np.ndarray, axis: int, in_size: int,
                    out_size: int) -> np.ndarray:
    first, count, k = _coefficients_reference(in_size, out_size)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int32)
    for t in range(k.shape[1]):
        idx = np.minimum(first + t, in_size - 1)
        taps = np.take(img, idx, axis=axis).astype(np.int32)
        acc += taps * np.where(t < count, k[:, t], 0).reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_reference(img: np.ndarray, out_h: int,
                              out_w: int) -> np.ndarray:
    """Plain numpy version of ``resize_bilinear`` (the whole result)."""
    h, w = img.shape[:2]
    out = img
    if out_w != w:
        out = _pass_reference(out, 1, w, out_w)
    if out_h != h:
        out = _pass_reference(out, 0, h, out_h)
    return np.array(out, np.uint8)


def _nearest_indices_reference(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's affine-scale source index per output (-1 outside): the
    coordinate starts at 0.5 * scale and accumulates the scale in double."""
    a = float(np.float32(in_size)) / out_size
    steps = np.full(out_size, a)
    steps[0] = 0.0 + a * 0.5
    v = np.add.accumulate(steps)
    j = np.where(v < 0.0, -1, v.astype(np.int64))
    return np.where((j >= 0) & (j < in_size), j, -1)


def resize_nearest_reference(img: np.ndarray, out_h: int,
                             out_w: int) -> np.ndarray:
    """Plain numpy version of ``resize_nearest`` (the whole result)."""
    ys = _nearest_indices_reference(img.shape[0], out_h)
    xs = _nearest_indices_reference(img.shape[1], out_w)
    out = img[np.maximum(ys, 0)][:, np.maximum(xs, 0)]
    out[ys < 0] = 0
    out[:, xs < 0] = 0
    return out
