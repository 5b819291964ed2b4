"""The port's PNG decode and encode and its Pillow-exact resamples
(mgnet_tpu_torch/data/image_io.py and csrc/image_ops.cpp) against Pillow,
bit for bit, and the C++ routines against their numpy versions; the host
library's build under concurrent builders."""

from __future__ import annotations

import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mgnet_tpu_torch.data import image_io
from mgnet_tpu_torch.data.transforms import (
    CropTransform,
    ResizeTransform,
    TransformList,
)
from mgnet_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent


def _image(rng, h, w, c=3):
    """Noise over smooth gradients, so that filters and resamples have
    structure to get wrong."""
    gy, gx = np.mgrid[0:h, 0:w]
    grad = (gy * 255 // max(h - 1, 1) + gx * 255 // max(w - 1, 1)) // 2
    noise = rng.randint(0, 256, (h, w, c))
    out = np.where(rng.rand(h, w, 1) < 0.5, grad[..., None], noise)
    return out.astype(np.uint8) if c > 1 else out[..., 0].astype(np.uint8)


def _png(w, h, depth, colour, stream, interlace=0):
    """A PNG file from an already filtered stream."""
    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(body, zlib.crc32(t))))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return (image_io.PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(stream)) + chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# decode and encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,shape", [
    ("RGB", (61, 97, 3)), ("RGB", (1, 1, 3)), ("L", (40, 33)),
    ("RGBA", (29, 70, 4)), ("I;16", (31, 45)),
])
def test_read_png_equals_pillow(tmp_path, mode, shape):
    """Pillow writes with adaptive per-row filters."""
    rng = np.random.RandomState(len(mode) + shape[0])
    if mode == "I;16":
        a = rng.randint(0, 65536, shape).astype(np.uint16)
        a[: shape[0] // 2] = a[:1]
    else:
        a = _image(rng, *shape[:2], c=shape[2] if len(shape) == 3 else 1)
    p = tmp_path / "x.png"
    Image.fromarray(a).save(p)
    got = image_io.read_png(p)
    with Image.open(p) as im:
        assert im.mode == mode
        want = np.asarray(im) if mode == "I;16" else np.asarray(
            im.convert("RGB"))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_pillow_written_files_use_several_filters(tmp_path):
    """The adaptive filters of the files above are really exercised."""
    a = _image(np.random.RandomState(0), 64, 64)
    p = tmp_path / "x.png"
    Image.fromarray(a).save(p)
    data = p.read_bytes()
    idat = data.index(b"IDAT")
    length = struct.unpack(">I", data[idat - 4:idat])[0]
    raw = zlib.decompress(data[idat + 4:idat + 4 + length])
    types = {raw[y * (1 + 64 * 3)] for y in range(64)}
    assert len(types) >= 2, types


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("fmt", ["rgb", "grey", "rgba", "grey16"])
def test_read_png_each_filter_type(tmp_path, ftype, fmt):
    colour, depth, samples, bpp = {"rgb": (2, 8, 3, 3), "grey": (0, 8, 1, 1),
                                   "rgba": (6, 8, 4, 4),
                                   "grey16": (0, 16, 1, 2)}[fmt]
    h, w = 23, 37
    rows = np.random.RandomState(ftype).randint(
        0, 256, (h, w * bpp)).astype(np.uint8)
    stream = image_io.png_filter_reference(rows, bpp, [ftype] * h)
    p = tmp_path / "f.png"
    p.write_bytes(_png(w, h, depth, colour, stream.tobytes()))
    got = image_io.read_png(p)
    with Image.open(p) as im:
        want = np.asarray(im) if depth == 16 else np.asarray(
            im.convert("RGB"))
    np.testing.assert_array_equal(got, want)
    if depth == 8:
        px = rows.reshape(h, w, samples)
        np.testing.assert_array_equal(
            got, np.repeat(px, 3, axis=2) if samples == 1 else px[..., :3])


@pytest.mark.parametrize("bpp,width", [(3, 41), (1, 64), (4, 9), (2, 30)])
def test_unfilter_cpp_equals_numpy(bpp, width):
    rng = np.random.RandomState(bpp)
    h = 25
    rows = rng.randint(0, 256, (h, width * bpp)).astype(np.uint8)
    stream = image_io.png_filter_reference(
        rows, bpp, rng.randint(0, 5, h)).tobytes()
    got = image_io.png_unfilter(stream, h, width * bpp, bpp)
    want = image_io.png_unfilter_reference(stream, h, width * bpp, bpp)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rows)


@pytest.mark.parametrize("arr", [
    np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3),
    np.arange(35, dtype=np.uint8).reshape(5, 7),
    np.arange(5 * 7 * 4, dtype=np.uint8).reshape(5, 7, 4),
    (np.arange(35, dtype=np.uint16) * 1871).reshape(5, 7),
], ids=["rgb", "grey", "rgba", "grey16"])
def test_write_png_pillow_reads_back(tmp_path, arr):
    p = tmp_path / "w.png"
    image_io.write_png(p, arr)
    with Image.open(p) as im:
        np.testing.assert_array_equal(np.asarray(im), arr)
    if arr.dtype == np.uint16:
        np.testing.assert_array_equal(image_io.read_png(p), arr)


def test_write_png_refuses_other_arrays(tmp_path):
    with pytest.raises(ValueError, match="no PNG format"):
        image_io.write_png(tmp_path / "x.png", np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="no PNG format"):
        image_io.write_png(tmp_path / "x.png", np.zeros((4, 4, 2), np.uint8))


@pytest.mark.parametrize("what", ["jpeg", "interlaced", "palette",
                                  "grey_alpha", "grey4", "crc", "truncated",
                                  "filter"])
def test_unsupported_or_broken_png_raises_with_the_file_name(tmp_path, what):
    p = tmp_path / f"{what}.png"
    a = _image(np.random.RandomState(3), 8, 8)
    if what == "jpeg":
        Image.fromarray(a).save(p, format="JPEG")
        match = "not a PNG"
    elif what == "interlaced":
        p.write_bytes(_png(8, 8, 8, 2, b"\0" * (8 * 25), interlace=1))
        match = "interlaced"
    elif what == "palette":
        Image.fromarray(a).convert("P").save(p)
        match = "palette"
    elif what == "grey_alpha":
        Image.fromarray(a).convert("LA").save(p)
        match = "grey\\+alpha"
    elif what == "grey4":
        p.write_bytes(_png(8, 8, 4, 0, b"\0" * (8 * 5)))
        match = "4-bit grey"
    elif what == "crc":
        Image.fromarray(a).save(p)
        data = bytearray(p.read_bytes())
        data[29] ^= 0xFF  # inside IHDR's CRC
        p.write_bytes(bytes(data))
        match = "CRC"
    elif what == "truncated":
        Image.fromarray(a).save(p)
        p.write_bytes(p.read_bytes()[:60])
        match = "truncated"
    else:
        stream = image_io.png_filter_reference(
            a.reshape(8, 24), 3, [0] * 8)
        stream[5, 0] = 7
        p.write_bytes(_png(8, 8, 8, 2, stream.tobytes()))
        match = "filter type in row 5"
    with pytest.raises(ValueError, match=match) as err:
        image_io.read_png(p)
    assert str(p) in str(err.value)


# ---------------------------------------------------------------------------
# Pillow-exact resampling: the shapes of tests/test_golden_mapper.py's resize
# parity (clean and non-integer downscales, upscales) and more
# ---------------------------------------------------------------------------

RESIZE_CASES = [
    ((128, 256), (96, 192)),    # clean downscale
    ((128, 256), (57, 114)),    # non-integer downscale
    ((100, 150), (137, 205)),   # upscale
    ((128, 256), (512, 1024)),  # 4x upscale
    ((37, 53), (37, 90)),       # width only
    ((37, 53), (80, 53)),       # height only
    ((300, 200), (61, 43)),     # 4.9x / 4.7x downscale
    ((64, 64), (64, 64)),       # identity
    ((7, 5), (1, 1)),
]


@pytest.mark.parametrize("hw,new", RESIZE_CASES)
@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_resample_bitexact_vs_pillow(hw, new, channels, method):
    img = _image(np.random.RandomState(hw[0] + new[1]), *hw, c=channels)
    pil = {"bilinear": Image.BILINEAR, "nearest": Image.NEAREST}[method]
    want = np.asarray(Image.fromarray(img).resize((new[1], new[0]), pil))
    cpp = getattr(image_io, f"resize_{method}")
    ref = getattr(image_io, f"resize_{method}_reference")
    np.testing.assert_array_equal(cpp(img, *new), want)
    np.testing.assert_array_equal(ref(img, *new), want)
    y0, x0 = new[0] // 3, new[1] // 4
    wh, ww = max(1, new[0] // 2), max(1, new[1] // 2)
    np.testing.assert_array_equal(cpp(img, *new, window=(y0, x0, wh, ww)),
                                  want[y0:y0 + wh, x0:x0 + ww])


def test_resample_refuses_what_pillow_would_premultiply_or_float():
    with pytest.raises(TypeError):
        image_io.resize_bilinear(np.zeros((4, 4, 4), np.uint8), 2, 2)
    with pytest.raises(TypeError):
        image_io.resize_nearest(np.zeros((4, 4, 3), np.float32), 2, 2)
    with pytest.raises(ValueError, match="bad sizes"):
        image_io.resize_bilinear(np.zeros((4, 4, 3), np.uint8), 8, 8,
                                 window=(4, 0, 8, 8))
    with pytest.raises(TypeError, match="uint8"):
        ResizeTransform(4, 4, 8, 8).apply_image(np.zeros((4, 4, 3),
                                                         np.float32))
    same = np.zeros((4, 4, 3), np.float32)  # no resize: passed through
    assert ResizeTransform(4, 4, 4, 4).apply_image(same) is same


@pytest.mark.parametrize("new,crop", [((160, 320), (5, 17, 64, 96)),
                                      ((57, 114), (0, 0, 57, 114)),
                                      ((64, 128), (10, 20, 64, 64))])
def test_resize_then_crop_runs_as_one_window(new, crop):
    """TransformList resamples only the crop's window: the same bytes as
    the whole resize cut by the crop (which clips to the image)."""
    img = _image(np.random.RandomState(1), 64, 128)
    y0, x0, h, w = crop
    r = ResizeTransform(64, 128, *new)
    c = CropTransform(x0, y0, w, h)
    fused = TransformList([r, c])
    np.testing.assert_array_equal(fused.apply_image(img),
                                  c.apply_image(r.apply_image(img)))
    seg = img[..., 0].copy()
    np.testing.assert_array_equal(fused.apply_segmentation(seg),
                                  c.apply_segmentation(
                                      r.apply_segmentation(seg)))


# ---------------------------------------------------------------------------
# the host library's build
# ---------------------------------------------------------------------------

_BUILDER = r"""
import sys, threading
from pathlib import Path
import numpy as np
from mgnet_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
from mgnet_tpu_torch.data import image_io
img = np.arange(6 * 10 * 3, dtype=np.uint8).reshape(6, 10, 3)
outs = []
threads = [threading.Thread(target=lambda: outs.append(
    image_io.resize_bilinear(img, 9, 4))) for _ in range(4)]
for t in threads:
    t.start()
for t in threads:
    t.join(120)
assert len(outs) == 4 and all((o == outs[0]).all() for o in outs)
np.save(sys.argv[2], outs[0])
"""


def test_concurrent_builders_all_load_the_library(tmp_path):
    """Two processes of four threads each build into one empty directory
    at once; each process loads a whole library and computes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILDER, str(tmp_path / "build"),
         str(tmp_path / f"out{i}.npy")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
    img = np.arange(6 * 10 * 3, dtype=np.uint8).reshape(6, 10, 3)
    want = np.asarray(Image.fromarray(img).resize((4, 9), Image.BILINEAR))
    for i in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"out{i}.npy"), want)
    built = sorted(n for n in os.listdir(tmp_path / "build"))
    assert len(built) == 1 and built[0].endswith(".so"), built


def test_failed_host_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "HOST_CSRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build.build_host()
    assert not list((tmp_path / "build").iterdir())
