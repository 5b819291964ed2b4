#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mgnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its findings:
  1. the device: name, count, and nvidia-smi's name and power limit;
     no card -> exit 1 (never carries on on the CPU);
  2. the build of every hand-written kernel (nvcc -> ctypes), its seconds;
  3. each kernel against its plain PyTorch version at the main path's
     shapes (center_argmin: [1, 1024, 2048], K=128, with invalid,
     duplicate and out-of-image centers): exact equality, then kernel and
     plain times (CUDA events) and the kernel's bound;
  4. the fused panoptic + depth frame at full width (ResNet-18, 20
     Cityscapes classes, MAX_INSTANCES=128, 1024x2048, bf16): backbone from
     weights/imagenet_weights.npz, GCM and heads from a seeded generator;
     the f32 frame on the card against the same frame on the CPU at a small
     size; three requests with kernel launches counted, outputs checked, and
     panoptic held against the plain clustering on the same head outputs;
     then the steady-state frame time;
  5. a JSON line of kernel numbers, nvidia-smi's line, and as the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises and the script exits non-zero without the last line.
It writes nothing but the kernel build directory (mgnet_tpu_torch/_build).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # elapsed seconds include the imports

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.data import (
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    Metadata,
    build_meta,
)
from mgnet_tpu_torch.inference import build_fused_inference, statics_from_meta
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.ops import _build
from mgnet_tpu_torch.ops.center_argmin import (
    center_argmin,
    center_argmin_reference,
    center_inputs,
)
from mgnet_tpu_torch.postprocessing.panoptic import (
    find_instance_centers,
    panoptic_fusion,
)
from mgnet_tpu_torch.train.step import normalize_images
from mgnet_tpu_torch.utils import load_jax_params

ROOT = Path(__file__).resolve().parent
H, W, K = 1024, 2048, 128
SEED = 0
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this script runs on the card only")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return name, count, smi


def phase_build():
    path, seconds = _build.build()
    _build.load_library()
    log(f"[build] {path.relative_to(ROOT)}: nvcc {seconds:.2f} s")


def center_argmin_case(gen):
    """Main-path shapes: coordinates near the grid, K=128 centers with
    invalid slots, duplicates (exact ties) and centers outside the image."""
    dev = DEVICE
    ys = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(W, device=dev, dtype=torch.float32)[None]
    py = (ys + 20 * torch.randn(1, H, W, generator=gen, device=dev))
    px = (xs + 20 * torch.randn(1, H, W, generator=gen, device=dev))
    scale = torch.tensor([H, W], device=dev, dtype=torch.float32)
    centers = torch.rand(1, K, 2, generator=gen, device=dev) * scale
    centers[:, 64:80] = centers[:, 0:16]
    centers[:, 120:124] = torch.tensor([-60.0, W + 90.0], device=dev)
    valid = torch.rand(1, K, generator=gen, device=dev) > 0.2
    return (py.contiguous(), px.contiguous(), *center_inputs(centers, valid))


def phase_kernels(smi):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    args = center_argmin_case(gen)
    got = center_argmin(*args)
    want = center_argmin_reference(*args)
    torch.cuda.synchronize()
    max_err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(
            f"center_argmin: kernel disagrees with the plain version on "
            f"{int((got != want).sum())} pixels (max |index diff| {max_err})")
    ms = cuda_ms(lambda: center_argmin(*args), iters=200)
    plain_ms = cuda_ms(lambda: center_argmin_reference(*args), iters=10)
    b, h, w = args[0].shape
    k = args[2].shape[1]
    n_bytes = b * h * w * (4 + 4 + 4) + 3 * b * k * 4
    n_ops = b * h * w * k * 5
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_S * 1e3
    row = dict(
        name="center_argmin", route="cuda",
        source="mgnet_tpu_torch/ops/csrc/center_argmin.cu",
        replaces="mgnet_tpu/ops/pallas/center_argmin.py:122",
        launches=None, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes > t_ops else "operations",
        library_ms=None,
    )
    log(f"[kernel] center_argmin [{b},{h},{w}] K={k}: exact "
        f"(max |index diff| {max_err}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}: {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} "
        f"G f32 ops); no single PyTorch call computes it; {smi}")
    return [row]


def build_slice(cfg, device, road_class_id=None):
    """Model and fused frame on ``device``. Weights are drawn on the CPU
    (so every device gets the same ones): backbone from the ImageNet npz,
    GCM and heads from a seeded generator. ``road_class_id`` overrides the
    panoptic id that DGC takes as the ground."""
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(SEED))
    npz = np.load(ROOT / "weights" / "imagenet_weights.npz")
    flat = {k[len("backbone/"):]: npz[k] for k in npz.files
            if k.startswith("backbone/")}
    model.backbone.load_state_dict(load_jax_params(flat, model.backbone))
    model.to(device)
    meta = Metadata(name="cityscapes_scene_seg").set(
        **build_meta(CITYSCAPES_SCENE_SEG_CATEGORIES))
    statics = statics_from_meta(cfg, meta)
    if road_class_id is not None:
        statics = statics._replace(road_class_id=road_class_id)
    fused = build_fused_inference(model, statics, cfg.MODEL.PIXEL_MEAN,
                                  cfg.MODEL.PIXEL_STD, device=device)
    return fused, statics, model


def slice_config(dtype: str):
    cfg = get_default_config()
    cfg.MODEL.COMPUTE_DTYPE = dtype
    cfg.INPUT.IGNORED_CATEGORIES_IN_DEPTH = ["ego vehicle", "sky"]
    return cfg


def request(i: int, h: int, w: int, device):
    """Request i: a seeded RGB image, its camera matrix and height."""
    rng = np.random.RandomState(SEED + i)
    image = torch.from_numpy(
        rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8)).to(device)
    f = (w / 2048) * (2262.0 - 150.0 * i)
    K_ = torch.tensor([[[f, 0.0, w / 2 - 0.5 + 7 * i],
                        [0.0, f, h / 2 - 0.5 - 5 * i],
                        [0.0, 0.0, 1.0]]], device=device)
    height = torch.tensor([1.22 + 0.1 * i], device=device)
    return image, K_, height


def phase_slice(smi):
    cfg = slice_config("bfloat16")
    fused, statics, model = build_slice(cfg, DEVICE)
    requests = [request(i, H, W, DEVICE) for i in range(3)]
    torch.cuda.synchronize()

    center_argmin.launches = 0
    outs = []
    for img, K_, height in requests:
        outs.append(fused(img, K_, height))
    torch.cuda.synchronize()
    launches = center_argmin.launches
    log(f"[slice] 3 requests at {H}x{W} bf16: center_argmin launches "
        f"{launches}")
    if launches < 1:
        raise AssertionError("the main path did not launch center_argmin")

    shapes = dict(sem_seg=((1, H, W), torch.int32),
                  panoptic=((1, H, W), torch.int32),
                  center=((1, H, W), torch.float32),
                  offset=((1, H, W, 2), torch.float32),
                  depth=((1, H, W), torch.float32),
                  points=((1, H, W, 3), torch.float32))
    pp = statics
    for i, out in enumerate(outs):
        for key, (shape, dtype) in shapes.items():
            got = (tuple(out[key].shape), out[key].dtype)
            if got != (shape, dtype):
                raise AssertionError(f"request {i}: {key} is {got}, "
                                     f"expected {(shape, dtype)}")
        pan = out["panoptic"]
        filtered = torch.zeros_like(pan, dtype=torch.bool)
        for cid in pp.depth_filter_ids:
            filtered |= pan == cid
        if not torch.isfinite(out["depth"][~filtered]).all():
            raise AssertionError(f"request {i}: non-finite depth")
        if not torch.isfinite(out["points"][~filtered]).all():
            raise AssertionError(f"request {i}: non-finite points")
        _, valid, _ = find_instance_centers(
            out["center"], pp.center_threshold, pp.nms_kernel,
            pp.max_instances)
        n_valid = int(valid.sum())
        if n_valid < 1:
            raise AssertionError(f"request {i}: no valid instance center")
        with torch.inference_mode():
            plain = panoptic_fusion(
                out["sem_seg"], out["center"], out["offset"],
                num_classes=pp.num_classes, last_stuff_id=pp.last_stuff_id,
                label_divisor=pp.label_divisor, stuff_area=pp.stuff_area,
                void_label=-1, threshold=pp.center_threshold,
                nms_kernel=pp.nms_kernel, max_instances=pp.max_instances,
                argmin=center_argmin_reference)
        if not torch.equal(plain, pan):
            raise AssertionError(
                f"request {i}: panoptic differs from the plain clustering "
                f"on {int((plain != pan).sum())} pixels")
        n_inst = int(torch.unique(pan[pan % pp.label_divisor > 0]).numel())
        ground = float((pan == pp.road_class_id).float().mean())
        depth_ok = out["depth"][~filtered]
        log(f"[slice] request {i}: valid centers {n_valid}, instances "
            f"{n_inst}, ground share {ground:.4f}, filtered share "
            f"{float(filtered.float().mean()):.4f}, depth median "
            f"{float(depth_ok.median()):.4f}; panoptic == plain clustering")

    img, K_, height = requests[0]
    for _ in range(10):
        fused(img, K_, height)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        fused(img, K_, height)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[slice] steady frame (1x{H}x{W}, bf16, image on the card): "
        f"{ms:.3f} ms/frame, {1e3 / ms:.2f} fps over {n} frames after 10 "
        f"warmup; peak allocated {peak:.3f} GiB; {smi}")
    breakdown(fused, model, cfg, requests[0], smi)
    return launches


def breakdown(fused, model, cfg, req, smi):
    """Where the frame's time goes: the model alone against the whole frame
    (CUDA events), and the profiler's device time by kernel over 5 frames
    (its sum against the frames' wall time gives the device's busy share)."""
    img, K_, height = req
    with torch.inference_mode():
        x = normalize_images(img, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    model_ms = cuda_ms(lambda: model(x), iters=20)
    frame_ms = cuda_ms(lambda: fused(img, K_, height), iters=20)
    log(f"[breakdown] model {model_ms:.3f} ms, post-processing (frame - "
        f"model) {frame_ms - model_ms:.3f} ms, frame {frame_ms:.3f} ms "
        f"(CUDA events); {smi}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n = 5
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fused(img, K_, height)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.self_device_time_total / 1e3 / n, e.count / n, e.key)
            for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(r[0] for r in rows)
    log(f"[breakdown] profiler: kernels busy {busy:.3f} of {wall_ms:.3f} "
        f"ms/frame wall under the profiler (idle share "
        f"{1 - busy / wall_ms:.3f}); {sum(r[1] for r in rows):.0f} kernel "
        f"launches/frame; top kernels:")
    for dev_ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"[breakdown]   {dev_ms:8.3f} ms/frame  x{count:5.1f}  {key[:90]}")


def phase_cpu_vs_card():
    """The f32 frame on the card against the CPU port at 128x256: the CPU
    port is the one the tests hold against the JAX package. Random heads
    rarely predict road, so the most common stuff class stands in as the
    DGC ground here, and the depth path computes a real scale."""
    cfg = slice_config("float32")
    img, K_, height = request(7, 128, 256, "cpu")
    cpu = build_slice(cfg, "cpu")[0]
    pan = cpu(img, K_, height)["panoptic"]
    stuff = pan[(pan >= 0) & (pan % 1000 == 0)]
    road = int(torch.bincount(stuff // 1000).argmax()) * 1000
    cpu = build_slice(cfg, "cpu", road)[0]
    card = build_slice(cfg, DEVICE, road)[0]
    got = {k: v.cpu() for k, v in card(img, K_, height).items()}
    want = cpu(img, K_, height)
    if not (want["depth"] > 0).any():
        raise AssertionError("card vs CPU: the DGC ground was empty")
    agree = {k: float((got[k] == want[k]).float().mean())
             for k in ("sem_seg", "panoptic")}
    same = got["panoptic"] == want["panoptic"]
    errs = {}
    for k in ("center", "offset", "depth", "points"):
        g, w = got[k], want[k]
        if k in ("depth", "points"):
            g, w = g[same], w[same]
        fin = torch.isfinite(w)
        if not torch.equal(fin, torch.isfinite(g)):
            raise AssertionError(f"card vs CPU: {k} finite masks differ")
        errs[k] = float(((g[fin] - w[fin]).abs()
                         / w[fin].abs().clamp(min=1.0)).max())
        # relative to max(|value|, 1)
    log(f"[cpu-vs-card] f32 frame 128x256 (ground = panoptic id {road}): "
        f"label agreement {agree}, max rel err {errs}, depth median "
        f"{float(want['depth'].median()):.4f}")
    # f32 through ~40 conv layers in other algorithms (cuDNN vs oneDNN)
    # and un-normalised random heads: the offset field differed by
    # 3.4e-3 of max(|value|, 1) on an H100 at 128x256; a wrong kernel,
    # layout or weight shows as O(1)
    if min(agree.values()) < 0.999 or max(errs.values()) > 1e-2:
        raise AssertionError("card and CPU frames disagree")


def main() -> int:
    import mgnet_tpu_torch

    if Path(mgnet_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"chip_smoke: mgnet_tpu_torch must come from {ROOT}")
    name, count, smi = phase_device()
    phase_build()
    rows = phase_kernels(smi)
    phase_cpu_vs_card()
    rows[0]["launches"] = phase_slice(smi)
    log(f"[done] elapsed {time.perf_counter() - T_START:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
