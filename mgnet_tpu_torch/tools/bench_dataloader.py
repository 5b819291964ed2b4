"""Host decode and resample throughput: the C++ host library against its
numpy versions.

    python -m mgnet_tpu_torch.tools.bench_dataloader [--height 1024]
        [--width 2048] [--iters 20] [--threads 1,4,8]

The counterpart of ``tools/bench_dataloader.py``, which held the JAX
package's native decode to Pillow and OpenCV. The card's machine has
neither, so this holds the port's C++ host library
(``data/csrc/image_ops.cpp``, through ``data.image_io``) to the plain
numpy versions beside it, on a seeded RGB frame of ``--height`` x
``--width``:

* ``read_png`` of the frame as ``write_png`` writes it (zlib inflate and
  the C++ unfilter);
* the unfilter alone on a stream of Sub and Up rows, C++ against
  ``png_unfilter_reference``, and on Paeth rows in C++ (the numpy version
  loops over pixels there, and is not timed);
* the Pillow-exact bilinear and nearest resizes to half size, C++ against
  ``resize_*_reference``;
* ``read_png`` of 16 files by a thread pool of each of ``--threads``
  sizes (ctypes releases the interpreter lock in the C++ calls, so the
  loader's threads scale).

Each row checks that both versions agree bit for bit. It runs on the
host; the last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from mgnet_tpu_torch.data.image_io import (
    png_filter_reference,
    png_unfilter,
    png_unfilter_reference,
    read_png,
    resize_bilinear,
    resize_bilinear_reference,
    resize_nearest,
    resize_nearest_reference,
    write_png,
)

__all__ = ["main", "parse_args"]


def bench(fn, n: int) -> float:
    """Host seconds per call of ``fn()`` after one warmup call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--threads", default="1,4,8",
                   help="thread-pool sizes of the parallel decode")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    h, w, n = args.height, args.width, args.iters
    img = np.random.RandomState(0).randint(0, 255, (h, w, 3), np.uint8)
    rows = {}

    def row(name, seconds):
        rows[name] = round(seconds * 1e3, 3)
        print(f"{name:44s} {seconds * 1e3:8.2f} ms/img "
              f"({1 / seconds:7.1f} img/s)", flush=True)

    def same(a, b, what):
        if not np.array_equal(a, b):
            raise AssertionError(f"{what}: C++ and numpy differ")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.png")
        write_png(path, img)
        same(read_png(path), img, "read_png")
        row(f"read_png {h}x{w} (zlib + C++ unfilter)",
            bench(lambda: read_png(path), n))

        flat = img.reshape(h, w * 3)
        for name, types in (("Sub/Up", [1 + (y % 2) for y in range(h)]),
                            ("Paeth", [4] * h)):
            stream = png_filter_reference(flat, 3, types).tobytes()
            same(png_unfilter(stream, h, w * 3, 3), flat, name)
            row(f"C++ unfilter, {name} rows",
                bench(lambda: png_unfilter(stream, h, w * 3, 3), n))
            if name == "Sub/Up":
                same(png_unfilter_reference(stream, h, w * 3, 3), flat, name)
                row(f"numpy unfilter, {name} rows", bench(
                    lambda: png_unfilter_reference(stream, h, w * 3, 3),
                    max(1, n // 10)))

        for name, fast, plain in (
                ("bilinear", resize_bilinear, resize_bilinear_reference),
                ("nearest", resize_nearest, resize_nearest_reference)):
            same(fast(img, h // 2, w // 2), plain(img, h // 2, w // 2), name)
            row(f"C++ {name} resize -> {h // 2}x{w // 2}",
                bench(lambda: fast(img, h // 2, w // 2), n))
            row(f"numpy {name} resize -> {h // 2}x{w // 2}",
                bench(lambda: plain(img, h // 2, w // 2), max(1, n // 10)))

        paths = []
        for i in range(16):
            paths.append(os.path.join(d, f"f{i}.png"))
            write_png(paths[-1], img)
        threaded = {}
        for workers in (int(t) for t in args.threads.split(",")):
            with ThreadPoolExecutor(workers) as pool:
                t0 = time.perf_counter()
                list(pool.map(read_png, paths))
                dt = time.perf_counter() - t0
            threaded[workers] = round(16 / dt, 2)
            print(f"read_png x16, {workers} threads{'':20s} "
                  f"{dt * 1e3:8.1f} ms total ({16 / dt:6.1f} img/s)",
                  flush=True)
    result = {"metric": "host_decode_resample_ms", "rows_ms": rows,
              "threaded_read_png_img_per_s": threaded,
              "hw": [h, w], "host_cores": os.cpu_count()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
