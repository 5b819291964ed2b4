#!/usr/bin/env python3
"""Tile sweep of the center_argmin kernel on one CUDA card.

    python3 tools/sweep_torch_center_argmin.py [--rounds 5] [--iters 100]
        [--tiles 8x32 32x32] [--pix 4 8 16] [--parent PATH]

Builds variants of ``mgnet_tpu_torch/ops/csrc/center_argmin.cu`` with the
tile and pixels per thread set by ``-DCENTER_TILE_H``, ``-DCENTER_TILE_W``
and ``-DCENTER_PIX`` (default: 8x32, 16x32, 32x32, 16x64 and 8x128 tiles,
4, 8 and 16 pixels a thread where that makes whole warps), one
``nvcc -Xptxas -v`` per variant, all
started together, into ``mgnet_tpu_torch/_build/sweep/``; with
``--parent``, an earlier ``center_argmin.cu`` (entry ``(..., batch, n, k,
stream)``) beside them. The cases are chip_smoke.py's: A (the main path's
test data), B (request 0's own clustering inputs from the frame at
1024x2048), C (scattered targets), D (KITTI's 384x1280), E (instance-like
targets). Every variant is held bit for bit against
``center_argmin_reference`` on every case, and on small ragged and
misaligned planes, and its count of scanned (tile, center) pairs against
``center_candidates_reference`` at its tile; then all are timed with CUDA
events in rounds that visit every variant in turn, the launches queued
behind a spin of the card. Prints a table (median, min and max over the
rounds; kept share; registers, spill-store and stack bytes from ptxas)
and, last, one JSON line.
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
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
from mgnet_tpu_torch.ops import _build  # noqa: E402
from mgnet_tpu_torch.ops.center_argmin import (  # noqa: E402
    center_argmin_reference,
    center_candidates_reference,
)
from torch_center_cases import CASES, center_case, misaligned  # noqa: E402

SOURCE = ROOT / "mgnet_tpu_torch" / "ops" / "csrc" / "center_argmin.cu"
OUT_DIR = _build.BUILD_DIR / "sweep"
TILES = ["8x32", "16x32", "32x32", "16x64", "8x128"]
SPIN_CYCLES = 2**24  # ~8.5 ms at 1.98 GHz: longer than enqueuing a run


def build_variants(variants, parent: Path | None):
    """{variant: (library, ptxas usage)}; the parent under the key
    "parent"."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for v in variants:
        lib = OUT_DIR / "libcenter_argmin_{}x{}_p{}.so".format(*v)
        defs = [f"-DCENTER_TILE_H={v[0]}", f"-DCENTER_TILE_W={v[1]}",
                f"-DCENTER_PIX={v[2]}"]
        procs[v] = (lib, [*defs, str(SOURCE)])
    if parent is not None:
        procs["parent"] = (OUT_DIR / "libcenter_argmin_parent.so",
                           [str(parent)])
    running = {
        key: (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
             str(lib), *args], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
        for key, (lib, args) in procs.items()}
    built = {}
    for key, (lib, proc) in running.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}\n{err}")
        built[key] = (lib, ptxas_usage(err))
    return built


def ptxas_usage(log: str) -> list:
    """[registers, spill-store bytes, stack bytes] of the kernel's 16-byte
    (vector) instance."""
    usage, current = [None, 0, 0], False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = "center_argmin_kernel" in m.group(1) and \
                "ILb1E" in m.group(1)
        for k, pattern in enumerate((r"Used (\d+) registers",
                                     r"(\d+) bytes spill stores",
                                     r"(\d+) bytes stack frame")):
            m = re.search(pattern, line)
            if m and current:
                usage[k] = int(m.group(1))
    return usage


def load(lib_path: Path, old_entry: bool):
    """launch(py, px, cy, cx, c2, out, kept) for the library's entry."""
    fn = ctypes.CDLL(str(lib_path)).mgnet_center_argmin
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = ([vp] * 6 + [ll, ll, i32, vp] if old_entry else
                   [vp] * 6 + [ll, i32, i32, i32, vp, vp])
    fn.restype = i32

    def launch(py, px, cy, cx, c2, out, kept=None):
        b, h, w = py.shape
        k = cy.shape[1]
        ptrs = [t.data_ptr() for t in (py, px, cy, cx, c2, out)]
        stream = torch.cuda.current_stream().cuda_stream
        if old_entry:
            rc = fn(*ptrs, b, h * w, k, stream)
        else:
            rc = fn(*ptrs, b, h, w, k,
                    None if kept is None else kept.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{lib_path.name}: launch failed ({rc})")
        return out
    return launch


def frame_inputs():
    """Case B: request 0's clustering inputs, from the frame at 1024x2048
    (chip_smoke.py's serving configuration and weights)."""
    fused, pp, _ = chip_smoke.build_slice(chip_smoke.slice_config("bfloat16"),
                                          "cuda")
    out = fused(*chip_smoke.request(0, chip_smoke.H, chip_smoke.W, "cuda"))
    captured = []

    def capture(*args):
        captured.append(args)
        return center_argmin_reference(*args)

    chip_smoke.plain_panoptic(out, pp, capture)
    return captured[0]


def time_ms(launch, args, out, iters):
    launch(*args, out)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        launch(*args, out)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--tiles", nargs="+", default=TILES)
    ap.add_argument("--pix", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier center_argmin.cu, timed beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_torch_center_argmin: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[sweep] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    tiles = [tuple(map(int, t.split("x"))) for t in args.tiles]
    variants = [(th, tw, p) for (th, tw), p in
                itertools.product(tiles, args.pix)
                if tw % p == 0 and th * tw // p % 32 == 0
                and th * tw // p <= 1024]
    built = build_variants(variants, args.parent)
    launches = {v: load(lib, v == "parent") for v, (lib, _) in built.items()}

    chip_smoke.DEVICE = "cuda"
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    cases = chip_smoke.center_argmin_cases(gen)
    cases["B"] = frame_inputs()
    cases = {key: cases[key] for key in "ABCDE"}
    checks = [[t.cuda() for t in center_case(name, 2, 45, 70, 24, seed=s)]
              for s, name in enumerate(CASES)]
    checks += [misaligned(c) for c in checks]

    shares = {}
    for v, launch in launches.items():
        for i, case in enumerate([*cases.values(), *checks]):
            want = center_argmin_reference(*case)
            kept = torch.zeros(1, dtype=torch.int64, device="cuda")
            got = launch(*case, torch.empty_like(want), kept)
            torch.cuda.synchronize()
            n_diff = int((got != want).sum())
            if n_diff:
                raise AssertionError(f"variant {v}, case {i}: {n_diff} "
                                     f"pixels differ from the plain version")
            if v == "parent":
                continue
            mask = center_candidates_reference(*(t.cpu() for t in case),
                                               v[0], v[1])
            if int(kept) != int(mask.sum()):
                raise AssertionError(f"variant {v}, case {i}: kept "
                                     f"{int(kept)} pairs, the rule "
                                     f"{int(mask.sum())}")
            if i < len(cases):
                shares[(v, list(cases)[i])] = int(kept) / mask.numel()
    print(f"[sweep] {len(launches)} kernels bit for bit equal to the plain "
          f"version on cases {''.join(cases)} and {len(checks)} small "
          f"ones (ragged, misaligned, adversarial); kept pairs equal to "
          f"center_candidates_reference's at each tile", flush=True)

    outs = {key: torch.empty(c[0].shape, dtype=torch.int32, device="cuda")
            for key, c in cases.items()}
    times = {(v, key): [] for v in launches for key in cases}
    for _ in range(args.rounds):
        for v, launch in launches.items():
            for key, case in cases.items():
                times[(v, key)].append(time_ms(launch, case, outs[key],
                                               args.iters))
    print(f"[sweep] ms over {args.rounds} rounds of {args.iters} launches "
          f"(median [min, max]), kept share of (tile, center) pairs; {smi}")
    rows = []
    for v in launches:
        name = "parent" if v == "parent" else "{}x{} p{}".format(*v)
        row = dict(variant=name, ptxas=built[v][1])
        cells = []
        for key in cases:
            t = times[(v, key)]
            row[key] = dict(median=float(np.median(t)), min=min(t),
                            max=max(t), kept=shares.get((v, key)))
            kept = (f" kept {shares[(v, key)]:.4f}" if (v, key) in shares
                    else "")
            cells.append(f"{key} {np.median(t):.4f} [{min(t):.4f}, "
                         f"{max(t):.4f}]{kept}")
        rows.append(row)
        print(f"[sweep] {name:11s} ptxas {built[v][1]}: " + "; ".join(cells),
              flush=True)
    print(json.dumps({"sweep": rows, "device": smi}))


if __name__ == "__main__":
    main()
