#!/usr/bin/env python3
"""Tile sweep of the SSIM+L1 residual forward kernel on one CUDA card.

    python3 tools/sweep_torch_ssim_fwd.py [--rounds 5] [--iters 50]

Builds variants of ``mgnet_tpu_torch/ops/csrc/ssim.cu`` in which the
forward's constants are set anew: ``kFwdInnerC`` (3: the three channels
share a row step, their windows in registers; 4: C = 3 takes the kernel
that runs the channels one after the other), ``kFwdBand`` (output rows a
block walks), ``kFwdAhead`` (rows the C = 3 kernel loads ahead) and
``kFwdMinBlocks`` (the ``__launch_bounds__`` minimum of resident
one-warp blocks per SM, i.e. the register cap; 1 = no cap). One
``nvcc -Xptxas -v`` per variant, all started together, into
``mgnet_tpu_torch/_build/sweep/``. Each variant is held bit for bit
against ``ssim_residual_reference`` at small shapes and at the timed
ones, then timed with CUDA events in rounds that visit every variant in
turn, at the training step's [4, 3, 1024, 1024] and at KITTI's
[2, 3, 384, 1280]. KITTI's inputs (27.5 MB) fit in the 50 MB L2, so each
launch there reads the next of four copies, as a caller that has just
written other tensors would. The timed launches queue behind a spin of
the card, so that the host's time per call does not pace them. Prints a
table (median, min and max over the rounds; registers, spill-store and
stack bytes from ptxas) and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mgnet_tpu_torch.ops import _build  # noqa: E402
from mgnet_tpu_torch.ops.ssim import (  # noqa: E402
    _INV9,
    SSIM_C1,
    SSIM_C2,
    ssim_residual_reference,
)

SOURCE = ROOT / "mgnet_tpu_torch" / "ops" / "csrc" / "ssim.cu"
OUT_DIR = _build.BUILD_DIR / "sweep"
CHECK_SHAPES = [(2, 3, 37, 53), (1, 3, 129, 61), (1, 2, 33, 61),
                (1, 1, 17, 18), (2, 3, 13, 95)]
TIMED = {"train": (4, 3, 1024, 1024), "kitti": (2, 3, 384, 1280)}
L2_BYTES = 50 * 2**20
PEAK_BYTES_S = 3.35e12
SPIN_CYCLES = 2**24  # ~8.5 ms at 1.98 GHz: longer than enqueuing a round
WEIGHT = 0.85


def variant_source(text: str, inner_c: int, band: int, ahead: int,
                   min_blocks: int):
    for name, value in (("kFwdInnerC", inner_c), ("kFwdBand", band),
                        ("kFwdAhead", ahead), ("kFwdMinBlocks", min_blocks)):
        pattern = rf"constexpr int {name} = \d+;"
        text, n = re.subn(pattern, f"constexpr int {name} = {value};", text)
        if n != 1:
            raise RuntimeError(f"{SOURCE.name}: {n} matches of {pattern}")
    return text


def build_variants(variants):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    nvcc = _build._nvcc()
    procs = {}
    for v in variants:
        name = "ssim_c{}_b{}_a{}_m{}".format(*v)
        src = OUT_DIR / f"{name}.cu"
        src.write_text(variant_source(text, *v))
        lib = OUT_DIR / f"lib{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
               str(lib), str(src)]
        procs[v] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    built = {}
    for v, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n{out}\n{err}")
        built[v] = (lib, ptxas_usage(err))
    return built


def ptxas_usage(log: str) -> dict:
    """{kernel: [registers, spill-store bytes, stack bytes]} of the
    forward kernels."""
    usage, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = ("inner" if "ssim_fwd_kernel" in m.group(1) else
                       "planes" if "ssim_fwd_planes" in m.group(1) else None)
        for k, pattern in enumerate((r"Used (\d+) registers",
                                     r"(\d+) bytes spill stores",
                                     r"(\d+) bytes stack frame")):
            m = re.search(pattern, line)
            if m and current:
                usage.setdefault(current, [None, 0, 0])[k] = int(m.group(1))
    return usage


def load(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    vp, ll, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    fn = lib.mgnet_ssim_residual_fwd
    fn.argtypes = [vp, vp, vp, ll, i32, i32, i32, *[f32] * 6, vp]
    fn.restype = ctypes.c_int

    def launch(x, y, out):
        b, c, h, w = x.shape
        rc = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), b, c, h, w,
                SSIM_C1, SSIM_C2, WEIGHT, 1.0 - WEIGHT, _INV9, 1.0 / c,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{lib_path.name}: launch failed ({rc})")
        return out
    return launch


def inputs(shape, seed, copies=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    sets = []
    for _ in range(copies):
        x = torch.rand(shape, generator=g, device="cuda")
        y = (x + 0.2 * torch.randn(shape, generator=g, device="cuda"))
        sets.append((x, y.clamp(0, 1)))
    return sets


def time_ms(launch, sets, out, iters):
    for x, y in sets:
        launch(x, y, out)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for k in range(iters):
        x, y = sets[k % len(sets)]
        launch(x, y, out)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--inner", type=int, nargs="+", default=[3, 4])
    ap.add_argument("--bands", type=int, nargs="+", default=[6, 8, 16])
    ap.add_argument("--ahead", type=int, nargs="+", default=[0, 4])
    ap.add_argument("--min-blocks", type=int, nargs="+", default=[16, 24])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_torch_ssim_fwd: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[sweep] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    variants = list(itertools.product(args.inner, args.bands, args.ahead,
                                      args.min_blocks))
    built = build_variants(variants)
    launches = {v: load(lib) for v, (lib, _) in built.items()}

    for shape in CHECK_SHAPES + list(TIMED.values()):
        (x, y), = inputs(shape, seed=1)
        want = ssim_residual_reference(x, y, WEIGHT)
        for v, launch in launches.items():
            got = launch(x, y, torch.empty_like(want))
            torch.cuda.synchronize()
            n_diff = int((got != want).sum())
            if n_diff:
                raise AssertionError(f"variant {v} at {shape}: {n_diff} "
                                     f"elements differ from the plain "
                                     f"version")
    print(f"[sweep] {len(variants)} variants bit for bit equal to the "
          f"plain version at {CHECK_SHAPES + list(TIMED.values())}",
          flush=True)

    sets, outs, bound = {}, {}, {}
    for key, shape in TIMED.items():
        b, _, h, w = shape
        n_bytes = (2 * int(np.prod(shape)) + b * h * w) * 4
        copies = max(1, -(-2 * L2_BYTES // n_bytes))
        sets[key] = inputs(shape, seed=2, copies=copies)
        outs[key] = torch.empty(b, h, w, device="cuda")
        bound[key] = n_bytes / PEAK_BYTES_S * 1e3
    times = {(v, k): [] for v in variants for k in TIMED}
    for _ in range(args.rounds):
        for v in variants:
            for key in TIMED:
                times[(v, key)].append(time_ms(launches[v], sets[key],
                                               outs[key], args.iters))
    print(f"[sweep] ms over {args.rounds} rounds of {args.iters} launches "
          f"(median [min, max]); bound (bytes) train "
          f"{bound['train']:.4f} ms, kitti {bound['kitti']:.4f} ms; {smi}")
    rows = []
    for v in variants:
        inner_c, band, ahead, min_blocks = v
        row = dict(inner_c=inner_c, band=band, ahead=ahead,
                   min_blocks=min_blocks, ptxas=built[v][1])
        cells = []
        for key in TIMED:
            t = times[(v, key)]
            row[key] = dict(median=float(np.median(t)), min=min(t),
                            max=max(t))
            cells.append(f"{key} {np.median(t):.4f} [{min(t):.4f}, "
                         f"{max(t):.4f}] ({bound[key] / np.median(t):.3f} "
                         f"of bound)")
        rows.append(row)
        print(f"[sweep] kFwdInnerC={inner_c} kFwdBand={band:2d} "
              f"kFwdAhead={ahead} kFwdMinBlocks={min_blocks:2d} ptxas "
              f"{built[v][1]}: "
              + "; ".join(cells), flush=True)
    print(json.dumps({"sweep": rows, "device": smi}))


if __name__ == "__main__":
    main()
