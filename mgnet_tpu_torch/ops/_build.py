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

``build_runner`` compiles the C++ runner of exported frames
(``export/csrc/*.cpp``, which include PyTorch's headers) with ``g++`` and
links it with the center_argmin object that ``build`` keeps, into the same
directory.

The builds write to a name unique to the process and thread, then
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

__all__ = ["build", "build_host", "build_runner", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
)
HOST_CSRC_DIR = _PKG / "data" / "csrc"
GXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")
RUNNER_CSRC_DIR = _PKG / "export" / "csrc"
RUNNER_GXX_FLAGS = ("-O2", "-std=c++20")


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


def _private_object(path: Path) -> Path:
    """``_private`` for an object file: the ``.o`` suffix kept, which nvcc
    needs to take it as one."""
    return _private(path).with_suffix(".o")


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
    """Compile all kernel sources if needed, keeping each source's object
    (``<stem>_<tag>.o``) beside the library for ``build_runner``.

    Returns (library path, seconds spent compiling; 0.0 if it was built
    already).
    """
    sources = _sources()
    tag = _tag(NVCC_FLAGS, sources)
    lib = BUILD_DIR / f"libmgnet_kernels_{tag}.so"
    finals = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
    if lib.is_file() and all(obj.is_file() for obj in finals):
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [_private_object(obj) for obj in finals]
    tmp = _private(lib)
    t0 = time.perf_counter()
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(sources, objs)])
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
        for obj, final in zip(objs, finals):
            os.replace(obj, final)
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


def _torch_flags() -> tuple[list[str], Path]:
    """(g++ flags for code that includes PyTorch's C++ headers, the
    directory of PyTorch's libraries)."""
    import torch
    from torch.utils import cpp_extension

    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    flags = [*RUNNER_GXX_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
             *(f"-I{p}" for p in cpp_extension.include_paths())]
    return flags, Path(torch.__file__).resolve().parent / "lib"


def build_runner() -> tuple[Path, float]:
    """Compile the C++ runner of exported frames if needed:
    ``export/csrc/*.cpp`` (the runner, and ``mgnet::center_argmin``'s
    registration) with ``g++`` against PyTorch's headers, one process per
    source, all started together, then one link with the center_argmin
    object of the kernels' own nvcc build (``build``), CUDA's static
    runtime, and PyTorch's libraries (kept whether or not a symbol is
    referenced, so that the CUDA backend registers; found at run time
    through an rpath).

    Returns (executable path, seconds spent compiling; 0.0 if it was
    built already). A failed build raises."""
    lib, kernel_seconds = build()
    kernel_obj = BUILD_DIR / f"center_argmin_{_tag(NVCC_FLAGS, _sources())}.o"
    import torch

    flags, torch_lib = _torch_flags()
    sources = sorted(RUNNER_CSRC_DIR.glob("*.cpp"))
    tag = _tag([*flags, torch.__version__, lib.name], sources)
    exe = BUILD_DIR / f"mgnet_aoti_runner_{tag}"
    if exe.is_file():
        return exe, kernel_seconds
    cuda_lib = Path(_nvcc()).resolve().parent.parent / "lib64"
    objs = [_private_object(BUILD_DIR / f"{src.stem}_{tag}.o")
            for src in sources]
    tmp = _private(exe)
    t0 = time.perf_counter()
    try:
        _run([[_gxx(), *flags, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(sources, objs)])
        _run([[_gxx(), "-o", str(tmp), *map(str, objs), str(kernel_obj),
               f"-L{cuda_lib}", "-lcudart_static", "-ldl", "-lrt",
               "-lpthread", f"-L{torch_lib}", "-Wl,--no-as-needed",
               "-ltorch", "-ltorch_cuda", "-ltorch_cpu", "-lc10_cuda",
               "-lc10", "-Wl,--as-needed", f"-Wl,-rpath,{torch_lib}"]])
        os.replace(tmp, exe)
    finally:
        for obj in (*objs, tmp):
            obj.unlink(missing_ok=True)
    return exe, kernel_seconds + time.perf_counter() - t0


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
