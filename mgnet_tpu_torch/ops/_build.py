"""Build and load the package's hand-written CUDA kernels, and the data
pipeline's host library.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc -c`` process, all
started together, and one more ``nvcc`` call links the objects into a
shared library with a plain C interface, for ``sm_90a`` (Hopper), loaded
with ``ctypes``. The library lands in ``mgnet_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name that carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

``-fmad=false`` keeps nvcc from contracting a multiply and an add into
one FMA: the kernels evaluate their arithmetic in the order of their plain
PyTorch versions, one rounding per operation, and are held to them
bit for bit.

``build_host`` compiles the data pipeline's C++ (``data/csrc/*.cpp``:
PNG unfiltering and Pillow-exact resampling) with ``g++`` alone, no
``-march=native`` (a library built on one host loads on another) and no
``-l`` flag, into the same directory under the same hashed naming.
``-ffp-contract=off`` keeps its double coefficient arithmetic rounding as
Pillow's and the numpy versions' does.

Both builds write to a name unique to the process and thread, then
``os.replace`` it onto the final name: processes or threads that build at
once each produce a whole library, and the last rename wins.

Nothing here runs at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["build", "build_host", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
)
HOST_CSRC_DIR = _PKG / "data" / "csrc"
GXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")


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


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found on PATH: the host library of "
                       "mgnet_tpu_torch.data cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _tag(flags, sources: list[Path]) -> str:
    """A hash of the flags and the sources' names and bytes."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def _private(path: Path) -> Path:
    """A temporary name beside ``path`` that no other process or thread
    uses."""
    return path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")


def _run(cmds: list[list[str]]) -> None:
    """Run the commands as parallel processes; raise on the first failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{Path(cmd[0]).name} failed "
                          f"(rc={proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> tuple[Path, float]:
    """Compile all kernel sources if needed.

    Returns (library path, seconds spent compiling; 0.0 if it was built
    already).
    """
    sources = _sources()
    tag = _tag(NVCC_FLAGS, sources)
    lib = BUILD_DIR / f"libmgnet_kernels_{tag}.so"
    if lib.is_file():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{src.stem}_{tag}.{os.getpid()}.o"
            for src in sources]
    tmp = _private(lib)
    t0 = time.perf_counter()
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(sources, objs)])
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


def build_host() -> tuple[Path, float]:
    """Compile the data pipeline's C++ sources with g++ if needed.

    Returns (library path, seconds spent compiling; 0.0 if it was built
    already). A failed build raises."""
    sources = sorted(HOST_CSRC_DIR.glob("*.cpp"))
    lib = BUILD_DIR / f"libmgnet_image_ops_{_tag(GXX_FLAGS, sources)}.so"
    if lib.is_file():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _private(lib)
    t0 = time.perf_counter()
    try:
        _run([[_gxx(), *GXX_FLAGS, "-o", str(tmp), *map(str, sources)]])
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib, time.perf_counter() - t0


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library, once per
    process, and declare the C signatures."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    i32, f32 = ctypes.c_int, ctypes.c_float
    signatures = {
        "mgnet_center_argmin": [vp, vp, vp, vp, vp, vp, ll, i32, i32, i32,
                                vp, vp],
        "mgnet_warp_bilinear": [vp, vp, vp, vp, vp, ll, i32, i32, i32, ll,
                                vp],
        "mgnet_ssim_residual_fwd": [vp, vp, vp, ll, i32, i32, i32,
                                    *[f32] * 6, vp],
        "mgnet_ssim_residual_bwd": [vp, vp, vp, vp, vp, ll, i32, i32, i32,
                                    *[f32] * 6, vp],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
