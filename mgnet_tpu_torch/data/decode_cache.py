"""Decode-once cache for epoch-repeating training images.

A copy of ``mgnet_tpu/data/decode_cache.py``, decoding through
``image_io.read_png``. The 60k-iteration schedule visits each Cityscapes
frame some 240 times; this cache pays the decode once and stores the raw
uint8 array on local disk (``<cache_dir>/<sha1>.npy``); later epochs
``np.load(mmap_mode="r")`` it.

* Disk-backed, not RAM: the kernel page cache keeps the hot set resident.
* Keyed by (absolute path, mtime_ns, size): editing a source image
  invalidates its entry.
* Safe for several writers: entries are written to a temporary file in the
  cache dir and ``os.replace``d; writers of the same key race benignly.
* Returned arrays are READ-ONLY views; every consumer in the mapper chain
  allocates its output, so no copy is needed.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Optional

import numpy as np

from mgnet_tpu_torch.data import image_io

__all__ = ["DecodeCache", "build_decode_cache"]


class DecodeCache:
    """path -> decoded uint8 array, disk-backed decode-once cache."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def _entry(self, path: str) -> str:
        st = os.stat(path)
        key = f"{os.path.abspath(path)}|{st.st_mtime_ns}|{st.st_size}"
        return os.path.join(
            self.cache_dir,
            hashlib.sha1(key.encode()).hexdigest() + ".npy")

    def get(self, path: str,
            decode=None) -> np.ndarray:
        """Decoded image for ``path`` (read-only view on a hit).

        ``decode``: callable path -> np.ndarray used on a miss; defaults
        to ``image_io.read_png``.
        """
        entry = self._entry(path)
        try:
            arr = np.load(entry, mmap_mode="r")
            return arr
        except (FileNotFoundError, ValueError):
            pass  # miss, or truncated entry from a crashed writer
        if decode is None:
            decode = image_io.read_png
        arr = decode(path)
        self._put(entry, arr)
        out = arr.view()
        out.flags.writeable = False
        return out

    def _put(self, entry: str, arr: np.ndarray) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, arr)
            os.replace(tmp, entry)
        except OSError:
            # cache is best-effort: a full/read-only disk must not kill
            # the training job
            try:
                os.unlink(tmp)
            except OSError:
                pass


def build_decode_cache(cfg) -> Optional[DecodeCache]:
    """DecodeCache from cfg.DATALOADER.DECODE_CACHE_DIR ('' = off)."""
    d = getattr(cfg.DATALOADER, "DECODE_CACHE_DIR", "")
    return DecodeCache(d) if d else None
