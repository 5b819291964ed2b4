"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ONE ``nvcc`` call into a shared
library with a plain C interface, for ``sm_90a`` (Hopper), and loaded with
``ctypes``. The library lands in ``mgnet_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is reused.

Nothing here runs at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of mgnet_tpu_torch cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build() -> tuple[Path, float]:
    """Compile all kernel sources if needed.

    Returns (library path, seconds spent compiling; 0.0 if it was built
    already).
    """
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libmgnet_kernels_{digest.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc={res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    return lib, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library, once per
    process, and declare the C signatures."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.mgnet_center_argmin.argtypes = [
        vp, vp, vp, vp, vp, vp, ll, ll, ctypes.c_int, vp]
    lib.mgnet_center_argmin.restype = ctypes.c_int
    return lib
