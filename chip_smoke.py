#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mgnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--parent-center-argmin PATH]

Phases, each printing its findings:
  1. the device: name, count, and nvidia-smi's name and power limit;
     no card -> exit 1 (never carries on on the CPU);
  2. the build of every hand-written kernel (one nvcc per source, in
     parallel, then one link -> ctypes), its seconds;
  3. each kernel against its plain PyTorch version at the main paths'
     shapes, then kernel and plain times (CUDA events) and the kernel's
     bound: center_argmin at [1, 1024, 2048], K=128, with invalid,
     duplicate and out-of-image centers (case A, exact equality), then
     on scattered targets (C), at KITTI's [1, 384, 1280] (D) and on
     instance-like targets (E), each with the kept share of (tile, center)
     pairs from the kernel's own counter and from
     center_candidates_reference, the bound of the pairs this data needs,
     and, given --parent-center-argmin (a center_argmin.cu with the
     entry (..., batch, n, k, stream) of earlier versions), that kernel's
     time in the same run; the warp at
     [4, 3, 1024, 1024] on view-synthesis coordinates plus integer,
     partly and fully off-image ones (value, gx, gy), beside
     F.grid_sample forward and forward+backward; the SSIM residual
     forward and backward at [4, 3, 1024, 1024] (the forward also at
     KITTI's [2, 3, 384, 1280], the backward also against autograd
     through the plain forward);
  4. the fused panoptic + depth frame at full width (ResNet-18, 20
     Cityscapes classes, MAX_INSTANCES=128, 1024x2048, bf16): backbone from
     weights/imagenet_weights.npz, GCM and heads from a seeded generator;
     the f32 frame on the card against the same frame on the CPU at a small
     size; three requests with kernel launches counted, outputs checked, and
     panoptic held against the plain clustering on the same head outputs;
     center_argmin on request 0's own clustering inputs (case B), as in
     phase 3; then the steady-state frame time;
  5. one f32 training step on the card against the same step on the CPU
     (batch 2, 128x256, same weights and batch): every loss, and every
     parameter's gradient by cosine;
  6. the joint training step at full width (the Cityscapes-Fine recipe:
     ResNet-18, 20 classes, OHEM, multi-scale depth heads, PoseCNN,
     uncertainty weighting, Adam, clip 0.01; bf16 autocast), batch 4 of
     1024x1024 synthetic crops made from the seed: 2 warmup steps, then
     5 timed steps with every loss printed and checked finite, the
     kernel launches of every step (warp 6, SSIM forward 8, SSIM
     backward 6), step ms, images/s, peak memory, and the profiler's
     busy share;
  7. the shipped configs/*.yaml, each read by the port's load_config:
     VideoSequence checked to differ from Fine in DATASETS.TRAIN only;
     training steps at the recipe's batch of 12 (2 warmup, 3 timed, as in
     6, launches checked against what each configuration implies): Fine
     at 1024x1024 in one pass, as 3 x 4 (GRAD_ACCUM_STEPS 3) and under
     MODEL.REMAT, the Cityscapes pseudo-label (panoptic-only) model, which
     must launch no warp or SSIM kernel, and KITTI-Eigen-Zhou at its
     uncropped 384x1280 with 19 classes; after the timed steps of each
     configuration with depth, one more step with the inputs and outputs
     of the last warp, SSIM forward and SSIM backward call kept (under
     REMAT the backward's recompute, under accumulation the last
     micro-batch), each held against its plain version bit for bit;
     the fused frames of
     KITTI-Eigen-Zhou at 384x1280 and of both pseudo-label configs
     (panoptic only) at 1024x2048 and 384x1280, each with one
     center_argmin launch, checked outputs and panoptic held against the
     plain clustering, and its steady time; one f32 step on the card
     against the CPU with GRAD_ACCUM_STEPS 2, REMAT, SGD, FREEZE_AT 2 and
     WarmupCosineLR (batch 4, 128x256), held to phase 5's bars;
  8. the trainer from a dataset on disk: a Cityscapes-layout panoptic tree
     of 8 frames at 1024x2048 (each also in the sequence directory with
     its -/+1 frames, panoptic
     PNGs of road, sky, a person and two cars, camera and panoptic JSON)
     written by data.write_cityscapes_tree into a temporary directory,
     every PNG read back
     by read_png and held to what was written; the host library's unfilter
     (filters 0-4) and Pillow-exact resamples (1024x2048 -> 2048x4096 and
     -> 512x1024, bilinear and nearest) held to their numpy versions;
     tools/train_net.py's main on configs/MGNet-Cityscapes-Fine.yaml as it
     is (batch 12 of 1024x1024 crops, bf16, the ImageNet npz) with
     MAX_ITER 4, CHECKPOINT_PERIOD 2, TEST.EVAL_PERIOD 0: every step's
     losses finite and its launches equal to expected_launches(cfg), the
     npz graft matched, checkpoints 2 and 4 and model_final written; a
     second Trainer with --resume, MAX_ITER 6 and TEST.EVAL_PERIOD 6 whose
     restored state equals the step-4 checkpoint bit for bit, then 2 more
     iterations, the second ending in Trainer.test over the tree's val
     split (its metrics finite in metrics.json, its seconds apart);
     ms/iteration, the wait on the loader and the checkpoint writes apart;
     the same step on one batch with no loader running; the mapper's
     ms/sample
     by stage (PNG read, resize + crop, colour jitter, targets) on one
     thread, the host's core count, the loader's samples/s and peak
     memory;
  9. evaluation: first (after phase 5, so that a fault shows early), the
     f32 evaluate_dataset on the card and on the CPU, each against the
     model's float64 reference on the CPU, on a small val tree (narrow
     widths): panoptic maps on >= 99.9% of pixels, metrics within
     EVAL_F64_REL (a median of float16 depths within
     EVAL_F64_MEDIAN_REL), 3 center_argmin launches on the card; then, on
     the trainer tree's val split (6 frames at 1024x2048 and one at
     1000x2000: a batch of 4, a tail of 2 and a second bucket key of 1,
     with 16-bit disparity PNGs),
     train_net --eval-only on the Fine YAML as it is (TEST.IMS_PER_BATCH
     4, NUM_WORKERS 10, bf16) with the trainer's model_final, with
     TEST.EVAL_INSTANCE False and then True: the JAX evaluators' key set
     in metrics.json, every
     value finite, center_argmin launches equal to the device batches, the
     last center_argmin inputs of each fusion shape held to
     center_argmin_reference bit for bit (with the kept pairs, as in
     phase 3), images/s, peak memory, ms per device batch by stage (eval
     step, post-processing, copy to the host) and host ms per sample in
     each evaluator and the GT PNG reads; then the multi-scale + flip TTA
     of the pseudo-label YAML (panoptic only) from the ImageNet npz with
     seeded heads, its images/s and peak memory;
  10. the serving entry points on the trainer tree, with the trainer's
     model_final: the Predictor on the Fine YAML with the tree's camera
     JSON on 3 frames of 1024x2048, each call one center_argmin launch
     and its outputs equal, bit for bit, to the frame built on the same
     model and called on the same resized image and co-augmented camera;
     ms per call (host clock) and one call's stages (resize, copy in,
     frame, copy out); predict_batch at batch 4: outputs=("panoptic",)
     equal to the full dict's, materialize=False returning tensors on
     the card, an unknown key and "points" without a camera raising; the
     pseudo-label YAML's Predictor (TTA, panoptic only) on one frame;
     tools.demo on 2 frames with --calib --save-pcl (every file decodes);
     tools.generate_pseudo_labels on the tree's 8 video-sequence frames at
     --batch 4 with --convert-json (8 uint16 label PNGs, 8 annotations,
     launches = device batches = 2, the steady img/s line); tools.bench
     with --breakdown (fps and stage rows);
  11. data-parallel training: (a) two gloo ranks spawned on the one card
     (NCCL refuses two ranks on one device) against one rank in this
     process, f32, TF32 off, the Fine recipe at full width, global batch
     4 of 256x512 (2 x 2 against 1 x 4), the same weights and batch, 2
     steps: every loss of both steps, the first step's per-leaf gradient
     cosine distance (median, worst) and the BN running statistics after
     it held to bar (iii) (DIST_*), the ranks' parameters equal bit for
     bit, and in each rank the last warp, SSIM forward and backward call
     held to its plain version bit for bit; (b) the same two ranks take
     one bf16 step each at 1024x1024, global batch 4, launches checked
     (warp 6, SSIM forward 8, backward 6 a step) -- two ranks sharing one
     card; (c) train_net --num-devices <cards> over NCCL on the trainer
     tree, 2 iterations and a resume of 1: rank-0-only files, the resumed
     state equal to its checkpoint (with 2 or more cards, (a) again over
     NCCL across 2 cards); (d) phase 6's world-size-1 step called no
     collective and launched within PARENT_LAUNCHES kernels a step;
  12. export: phase 4's frame (1024x2048, bf16, with a camera) through
     export.export_fused_inference (torch.export) and save_exported
     (AOTInductor), their seconds and the artifacts' bytes; the package
     loaded in Python and held to the eager frame at export.BARS (or
     missing no more than BF16_OPEN_FAULT records) on request 0's image
     with the runner's camera; under torch.profiler the center_argmin
     kernel launched once a frame by the package, and the
     package's and the eager frame's launches and busy time; both frames
     timed in turns; the C++ runner (export/csrc/aoti_runner.cpp, built by
     ops._build.build_runner) on the same package and image: its latency
     line, its FNV-1a of the panoptic output equal to the Python
     package's, one center_argmin launch a frame; then
     tools.export_inference --verify on the trainer's model_final at
     256x512 in float32: the reloaded ExportedProgram equal to the live
     frame bit for bit, then the package at export.BARS;
  13. the overfit validations: tools.validate_depth_overfit --mode
     gt_depth (1200 steps) and gt_pose (2000 steps) at widths 256 and 512,
     each PASS, through the warp and SSIM kernels on every step (launches
     checked), with its loss, depths or translations and seconds; then
     tools.validate_overfit (panoptic, six synthetic scenes) at
     OVERFIT_STEPS, its loss falling and PQ, PQ_things, PQ_stuff and mIoU
     printed beside the JAX package's after 1200 steps (at 1200 steps its
     gate, PQ > 80 and mIoU > 80, must pass); meanwhile a child process
     runs tools.export_inference --verify in bfloat16 on the trainer's
     model_final at 256x512: its program must equal the live frame bit
     for bit, and its package hold export.BARS or miss no more than the
     open fault that BF16_OPEN_FAULT records;
  14. a JSON line of kernel numbers (with each path's launches), the total
     elapsed seconds, nvidia-smi's line, and as the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises and the script exits non-zero without the last line.
It writes the kernel and host library build directory
(mgnet_tpu_torch/_build) and, for the trainer phase, a temporary directory
that it removes.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # elapsed seconds include the imports

import argparse
import contextlib
import copy
import ctypes
import io
import itertools
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

import torch.nn.functional as F

import mgnet_tpu_torch.data.mapper as mapper_module
import mgnet_tpu_torch.evaluation.depth as eval_depth
import mgnet_tpu_torch.geometry.image as geometry_image
import mgnet_tpu_torch.ops.ssim as ops_ssim
import mgnet_tpu_torch.train.trainer as trainer_module
from mgnet_tpu_torch.config import (
    apply_cityscapes_fine,
    get_default_config,
    load_config,
)
from mgnet_tpu_torch.data import (
    CITYSCAPES_CATEGORIES,
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    DatasetCatalog,
    Metadata,
    MetadataCatalog,
    TrainDatasetMapper,
    TrainLoader,
    build_meta,
    read_png,
    register_all_cityscapes_scene_seg,
    synthetic_train_batch,
    write_cityscapes_tree,
)
from mgnet_tpu_torch.export import (
    BARS,
    BarsMissed,
    compare_outputs,
    export_fused_inference,
    fnv1a64,
    load_exported,
    save_exported,
)
from mgnet_tpu_torch.evaluation import (
    DepthEvaluator,
    InstanceAPEvaluator,
    PanopticEvaluator,
    SemSegEvaluator,
)
from mgnet_tpu_torch.data.image_io import (
    png_filter_reference,
    png_unfilter,
    png_unfilter_reference,
    resize_bilinear,
    resize_bilinear_reference,
    resize_nearest,
    resize_nearest_reference,
)
from mgnet_tpu_torch.geometry import Camera, Pose, synthesis_coords
from mgnet_tpu_torch.inference import (
    Predictor,
    build_fused_inference,
    fusion_kwargs,
    statics_from_meta,
)
from mgnet_tpu_torch.models import as_float64_, build_model, init_random_
from mgnet_tpu_torch.ops import _build
from mgnet_tpu_torch.ops.center_argmin import (
    TILE_H as CA_TILE_H,
    TILE_W as CA_TILE_W,
    center_argmin,
    center_argmin_reference,
    center_candidates_reference,
    center_inputs,
)
from mgnet_tpu_torch.ops.ssim import (
    ssim_residual_bwd,
    ssim_residual_bwd_reference,
    ssim_residual_fwd,
    ssim_residual_reference,
)
from mgnet_tpu_torch.ops.warp import warp_bilinear, warp_bilinear_reference
from mgnet_tpu_torch.parallel import (
    initialize_distributed,
    replicate_,
    shard_batch,
    shutdown_distributed,
)
from mgnet_tpu_torch.parallel.collectives import CALLS as COLLECTIVES
from mgnet_tpu_torch.postprocessing.panoptic import (
    find_instance_centers,
    panoptic_fusion,
)
from mgnet_tpu_torch.tools import (
    bench,
    demo,
    export_inference,
    generate_pseudo_labels,
    train_net,
    validate_depth_overfit,
    validate_overfit,
)
from mgnet_tpu_torch.train import create_train_state, make_train_step
from mgnet_tpu_torch.train.step import normalize_images
from mgnet_tpu_torch.train.trainer import Trainer, evaluate_dataset
from mgnet_tpu_torch.utils import load_jax_params
from mgnet_tpu_torch.utils.checkpoint import CheckpointManager
from mgnet_tpu_torch.utils.profiling import steady_state_timer

ROOT = Path(__file__).resolve().parent
H, W, K = 1024, 2048, 128
# training step: batch 4 of 1024x1024 crops (tools/bench_train.py's
# defaults; the recipe's global batch is 12)
TB, TH, TW = 4, 1024, 1024
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# the config phase: the shipped YAML files, the recipe's batch of 12 (the
# reference's global batch), Cityscapes' 1024x1024 crops and KITTI's
# uncropped 384x1280 frames; the frames at Cityscapes' 1024x2048
CONFIG_DIR = ROOT / "configs"
CFG_BATCH = 12
CFG_WARMUP, CFG_STEPS = 2, 3
KH, KW = 384, 1280
FRAME_WARMUP, FRAME_ITERS = 5, 20
# the f32 card-vs-CPU step with the config phase's options
SMALL_B, SMALL_H, SMALL_W = 4, 128, 256
# the trainer phase: a tree of 8 Cityscapes-size frames, the Fine YAML as
# it is (batch 12 of 1024x1024 crops) for 4 iterations, a resume for 2
# more, 1 batch of the loader alone, and the step timed STEP_ITERS times
# beside each of 0 (after a warmup step), 1, cores - 1 and NUM_WORKERS
# loader threads (each 2 before the distribution phase came, and each
# after a warmup step before the export phase came, cut to keep the run
# short); TRAINER_OPTS are extra overrides (none on the card)
TREE_FRAMES, TREE_H, TREE_W = 8, 1024, 2048
TRAINER_ITERS, TRAINER_RESUME, LOADER_BATCHES = 4, 2, 1
STEP_ITERS = 1
TRAINER_OPTS: tuple = ()
# the eval phase: the trainer tree's val split, 6 frames of the tree's
# size and one of 1000x2000 (a batch of TEST.IMS_PER_BATCH 4, a pow2 tail
# of 2, and a second bucket key whose fusion runs at a size that is not a
# multiple of the 32 x 32 tile); EVAL_OPTS are extra overrides of the
# eval-only runs (none on the card); the card against the CPU on a small
# tree of SMALL_VAL frames at narrow widths, each float32 run's metrics
# within EVAL_F64_REL of the float64 run's (the CPU tests' bar against
# the JAX package), apart from depth/scale_ratio_median: the median over
# the images of median(GT) / median(pred), where pred is the depth the
# eval loop compacts to float16, moves in steps of half a float16 ulp
# (2^-12 to 2^-11 of its value) when one pixel at an image's median rounds
# the other way; its bar is one float16 ulp, EVAL_F64_MEDIAN_REL (the
# H100 read 3.204e-4 there and the CPU 5.8e-7, PERF.md)
VAL_SIZES = ((TREE_H, TREE_W),) * 6 + ((1000, 2000),)
EVAL_OPTS: tuple = ()
SMALL_VAL = ((128, 256),) * 6 + ((120, 240),)
EVAL_F64_REL = 1e-4
EVAL_F64_MEDIAN_REL = 2 ** -10
# the serving phase: the trainer tree's frames through the Predictor (3
# calls), its batch of SERVE_BATCH, the pseudo-label TTA predictor, the
# demo (2 frames), the pseudo-label tool on the tree's 8 video-sequence
# frames at --batch SERVE_BATCH, and the bench; SERVE_OPTS are extra
# overrides and BENCH_ARGS extra bench flags (none on the card)
SERVE_BATCH = 4
SERVE_OPTS: tuple = ()
BENCH_ARGS: tuple = ()
# the distribution phase: DIST_RANKS gloo ranks spawned on the one card
# against one rank in this process, f32 with TF32 off, the Fine recipe at
# full width, global batch DIST_B at DIST_H x DIST_W for DIST_STEPS steps;
# then one bf16 step of the same ranks at the recipe's 1024x1024, global
# batch DIST_B; then train_net over NCCL on every visible card, 2
# iterations of DIST_CLI_PER_RANK samples per rank and a resume of 1. Bar
# (iii): losses and BN statistics DIST_REL, per-leaf gradient cosine
# distance median DIST_COS_MEDIAN and worst DIST_COS_WORST; the
# world-size-1 step no collective, and phase 6's step, profiled over 2
# steps, within PARENT_LAUNCHES kernels a step: 7236 in PRs 14-15; the
# count drifts by a few launches with the training state and between runs
# of one code and seed (PERF.md section 5)
DIST_RANKS, DIST_B, DIST_H, DIST_W, DIST_STEPS = 2, 4, 256, 512, 2
DIST_CLI_PER_RANK = 2
DIST_REL, DIST_COS_MEDIAN, DIST_COS_WORST = 1e-4, 1e-4, 2e-3
PARENT_LAUNCHES = (7229, 7240)
# the export phase: phase 4's frame (1024x2048, bf16, with a camera, the
# ImageNet backbone and seeded heads) through torch.export and
# AOTInductor; the package and the eager frame timed over EXPORT_WARMUP +
# EXPORT_ITERS frames each, in turns; the C++ runner over RUNNER_ITERS
# frames on the same image with its own camera (RUNNER_K, RUNNER_HEIGHT:
# export/csrc/aoti_runner.cpp's, which are native/src/pjrt_runner.cpp's);
# export_inference --verify on the trainer's model_final at
# EXPORT_VERIFY_H x EXPORT_VERIFY_W in float32
EXPORT_WARMUP, EXPORT_ITERS, RUNNER_ITERS = 10, 50, 50
EXPORT_VERIFY_H, EXPORT_VERIFY_W = 256, 512
RUNNER_K = ((2262.52, 0.0, 1096.98), (0.0, 2265.30, 513.137),
            (0.0, 0.0, 1.0))
RUNNER_HEIGHT = 1.22
# the validation phase: the depth ablations at the recipes of
# docs/depth_validation.md (gt_depth 1200 steps, gt_pose 2000) at each of
# ABLATION_WIDTHS, and the panoptic overfit at OVERFIT_STEPS of the
# recipe's 1200 (the 1200-step gate runs through the tool alone, PERF.md),
# while a child process runs export_inference --verify in bfloat16 on the
# trainer's model_final at EXPORT_VERIFY_H x EXPORT_VERIFY_W; the JAX
# package's quality targets after 1200 steps (BENCH_NOTES.md)
ABLATIONS = (("gt_depth", 1200), ("gt_pose", 2000))
# the bfloat16 AOTInductor package's open fault (ROADMAP Queue 3): the bars
# of export.BARS that it misses against the eager frame, each with the
# least share taken as that fault, a little below the least found on the
# H100 (PERF.md): phase 12's frame with seeded heads, depth 0.938 and
# points 0.941; the --verify on the trainer's model_final, center 0.794
# and 0.819. A miss of any other bar, or by more, fails the run
BF16_OPEN_FAULT = {"frame": {"depth": 0.9, "points": 0.9},
                   "model_final": {"center": 0.75}}
ABLATION_WIDTHS = (256, 512)
OVERFIT_STEPS = 300
JAX_OVERFIT = {"PQ": 96.9, "PQ_things": 90.9, "PQ_stuff": 99.96,
               "mIoU": 99.85}
PANOPTIC_KEYS = ["PQ", "SQ", "RQ", "PQ_th", "SQ_th", "RQ_th", "PQ_st",
                 "SQ_st", "RQ_st"]
DEPTH_KEYS = ["Abs Rel", "Sq Rel", "RMSE", "RMSE log", "δ < 1.25",
              "δ < 1.25²", "δ < 1.25³"]
SEED = 0
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 FLOP/s (an
# FMA counted as two operations), and the rates of operations that cannot
# be contracted into FMAs: f32 and f64 (34 TFLOP/s with FMAs)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_F32_PLAIN_S = 33.5e12
PEAK_F64_PLAIN_S = 17e12
# center_argmin: f32 operations per pixel and kept center, f64 operations
# per tile and center of its candidate rule (csrc/center_argmin.cu)
CA_PAIR_OPS = 5
CA_RULE_OPS = 56
# f32 operations of the SSIM forward per pixel and channel, as
# csrc/ssim.cu's header counts them
SSIM_FWD_OPS = 55


def log(*args):
    print(*args, flush=True)


def sync():
    """Wait for the card (nothing to wait for with DEVICE "cpu")."""
    if DEVICE != "cpu":
        torch.cuda.synchronize()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` launches (CUDA events). The
    launches queue behind a spin of the card (~17 ms at 1.98 GHz), so
    that the host's time per call (through a custom op's dispatch, tens
    of microseconds) does not pace a kernel shorter than it."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2**25)
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
    log(f"[build] {path.relative_to(ROOT)}: {len(_build._sources())} "
        f"sources, nvcc in parallel + link {seconds:.2f} s")


def bound(n_bytes: float, n_ops: float):
    """(bound ms, 'bytes' or 'operations') on the H100's published peaks."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def compare(name, got, want, atol, tag="kernel"):
    """Max |got - want| and the count of differing elements; raises above
    ``atol`` (0 = bit for bit)."""
    diff = (got - want).abs()
    err = float(diff.max())
    n_diff = int((got != want).sum())
    log(f"[{tag}]   {name}: max |diff| {err:.3e}, {n_diff} of "
        f"{got.numel()} elements differ (bar {atol:.1e})")
    if not err <= atol:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max |diff| {err} > {atol}")
    return err


def center_argmin_case(gen, h=H, w=W):
    """Main-path shapes: coordinates near the grid, K=128 centers with
    invalid slots, duplicates (exact ties) and centers outside the image."""
    dev = DEVICE
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None]
    py = (ys + 20 * torch.randn(1, h, w, generator=gen, device=dev))
    px = (xs + 20 * torch.randn(1, h, w, generator=gen, device=dev))
    scale = torch.tensor([h, w], device=dev, dtype=torch.float32)
    centers = torch.rand(1, K, 2, generator=gen, device=dev) * scale
    centers[:, 64:80] = centers[:, 0:16]
    centers[:, 120:124] = torch.tensor([-60.0, w + 90.0], device=dev)
    valid = torch.rand(1, K, generator=gen, device=dev) > 0.2
    return (py.contiguous(), px.contiguous(), *center_inputs(centers, valid))


def center_argmin_cases(gen):
    """Cases A (the main path's test data), C (targets uniform over the
    image, A's centers: nothing to prune but the sentinels), D (A's
    distribution at KITTI's serving shape, 384x1280) and E (each target
    within N(0, 2^2) of the valid center nearest its pixel, as a trained
    offset head gives on thing pixels; A's centers)."""
    a = center_argmin_case(gen)
    _, h, w = a[0].shape
    c = (torch.rand(1, h, w, generator=gen, device=DEVICE) * h,
         torch.rand(1, h, w, generator=gen, device=DEVICE) * w, *a[2:])
    d = center_argmin_case(gen, 384, 1280)
    ys = torch.arange(h, device=DEVICE, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=DEVICE, dtype=torch.float32)[None]
    near = center_argmin_reference(ys.expand(1, h, w).contiguous(),
                                   xs.expand(1, h, w).contiguous(),
                                   *a[2:])[0].long()
    e = tuple((t[0][near] + 2 * torch.randn(1, h, w, generator=gen,
                                            device=DEVICE)).contiguous()
              for t in a[2:4]) + a[2:]
    return {"A": a, "C": c, "D": d, "E": e}


def load_parent_center_argmin(source: Path):
    """Build a center_argmin.cu with the entry (py, px, cy, cx, c2, out,
    batch, n, k, stream) of earlier versions into its own library and
    return launch(py, px, cy, cx, c2, out)."""
    out_dir = _build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libparent_center_argmin.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(source)], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib_path)).mgnet_center_argmin
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [vp] * 6 + [ll, ll, ctypes.c_int, vp]
    fn.restype = ctypes.c_int

    def launch(py, px, cy, cx, c2, out):
        b, h, w = py.shape
        rc = fn(py.data_ptr(), px.data_ptr(), cy.data_ptr(), cx.data_ptr(),
                c2.data_ptr(), out.data_ptr(), b, h * w, cy.shape[1],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent center_argmin: launch failed ({rc})")
        return out
    return launch


def center_argmin_bound(args, mask):
    """(bound ms, by, all-pairs bound ms, MB, G f32 ops) of center_argmin
    on ``args``, where ``mask`` [B, nTy, nTx, K] is what the kernel scans:
    each plane read once and the output written once, against the f32
    operations of the kept (pixel, center) pairs at the non-FMA f32 rate
    plus the candidate rule's f64 operations at the f64 rate. The
    all-pairs figure is the bound of the kernel without pruning: every
    pair's operations at the FMA-counted f32 peak."""
    b, h, w = args[0].shape
    k = args[2].shape[1]
    n_bytes = b * h * w * (4 + 4 + 4) + 3 * b * k * 4
    rows = torch.full((-(-h // CA_TILE_H),), CA_TILE_H)
    rows[-1] = h - CA_TILE_H * (len(rows) - 1)
    cols = torch.full((-(-w // CA_TILE_W),), CA_TILE_W)
    cols[-1] = w - CA_TILE_W * (len(cols) - 1)
    pixels = (rows[:, None] * cols[None])[None, :, :, None]
    pair_ops = CA_PAIR_OPS * int((mask * pixels).sum())
    rule_ops = CA_RULE_OPS * mask.numel()
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = (pair_ops / PEAK_F32_PLAIN_S + rule_ops / PEAK_F64_PLAIN_S) * 1e3
    all_pairs = max(t_bytes, b * h * w * k * CA_PAIR_OPS / PEAK_F32_S * 1e3)
    return (max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations",
            all_pairs, n_bytes / 1e6, pair_ops / 1e9)


def center_argmin_report(case, args, smi, parent, plain=False):
    """One case: the kernel against the plain version (exact), its time,
    the parent kernel's time in this run, the kept share from the kernel's
    counter and from center_candidates_reference, and the bound of this
    data. Returns (max |index diff|, kernel ms, plain ms or None, bound ms,
    bound_by)."""
    kept = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    got = center_argmin(*args, kept_pairs=kept)
    want = center_argmin_reference(*args)
    torch.cuda.synchronize()
    max_err = float((got - want).abs().max())
    b, h, w = args[0].shape
    k = args[2].shape[1]
    if not torch.equal(got, want):
        raise AssertionError(
            f"center_argmin case {case}: kernel disagrees with the plain "
            f"version on {int((got != want).sum())} pixels (max |index diff| "
            f"{max_err})")
    mask = center_candidates_reference(*(t.cpu() for t in args))
    share = int(kept) / mask.numel()
    ref_share = float(mask.float().mean())
    if int(kept) != int(mask.sum()):
        raise AssertionError(f"center_argmin case {case}: the kernel kept "
                             f"{int(kept)} (tile, center) pairs, the rule "
                             f"{int(mask.sum())}")
    ms = cuda_ms(lambda: center_argmin(*args), iters=200)
    plain_ms = (cuda_ms(lambda: center_argmin_reference(*args), iters=10)
                if plain else None)
    if parent is None:
        parent_txt = "parent kernel not given"
    else:
        out = torch.empty_like(got)
        if not torch.equal(parent(*args, out), want):
            raise AssertionError(f"parent center_argmin case {case} differs")
        parent_txt = (f"parent kernel "
                      f"{cuda_ms(lambda: parent(*args, out), iters=200):.4f} "
                      f"ms")
    t_bound, by, all_pairs, mb, gops = center_argmin_bound(args, mask)
    log(f"[kernel] center_argmin case {case} [{b},{h},{w}] K={k}: exact "
        f"(max |index diff| {max_err}); kernel {ms:.4f} ms, {parent_txt}"
        + (f", plain {plain_ms:.4f} ms" if plain else "")
        + f"; kept share {share:.4f} of {mask.numel()} (tile, center) pairs "
        f"(kernel's counter), {ref_share:.4f} (center_candidates_reference)"
        f"; bound {t_bound:.4f} ms ({by}: {mb:.1f} MB, {gops:.3f} G f32 ops "
        f"of kept pairs), all-pairs bound {all_pairs:.4f} ms; {smi}")
    return max_err, ms, plain_ms, t_bound, by


def phase_kernels(smi, parent=None):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = center_argmin_cases(gen)
    max_err, ms, plain_ms, t_bound, by = center_argmin_report(
        "A", cases.pop("A"), smi, parent, plain=True)
    for case, args in cases.items():
        center_argmin_report(case, args, smi, parent)
    row = dict(
        name="center_argmin", route="cuda",
        source="mgnet_tpu_torch/ops/csrc/center_argmin.cu",
        replaces="mgnet_tpu/ops/pallas/center_argmin.py:122",
        launches=None, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=t_bound, bound_by=by, library_ms=None,
    )
    log("[kernel] center_argmin: no single PyTorch call computes it")
    return [row]


def exact_pixel_coords(n: int) -> torch.Tensor:
    """Normalized f32 coords c whose pixel coordinate (c + 1) * 0.5 * (n - 1)
    evaluates to the integer i exactly (the floor's edge case), where c or
    one of its f32 neighbours within 3 ulps does; NaN where none does."""
    k = torch.arange(n, device=DEVICE, dtype=torch.float32)
    c0 = (2.0 * k.double() / (n - 1) - 1.0).float()
    cands = [c0]
    for toward in (2.0, -2.0):
        c = c0
        for _ in range(3):
            c = torch.nextafter(c, torch.full_like(c, toward))
            cands.append(c)
    out = torch.full_like(c0, float("nan"))
    for c in cands:
        ok = ((c + 1.0) * 0.5 * (n - 1) == k) & torch.isnan(out)
        out = torch.where(ok, c, out)
    return out


def warp_case(gen):
    """Training-step shapes: a planar image [4, 3, 1024, 1024] and the
    view-synthesis coords of a seeded depth and a small pose, with rows
    0-7 on integer pixel coords, rows 8-15 just past the left/top border
    (one corner out), and rows 16-23 fully off the image."""
    image = torch.rand(TB, 3, TH, TW, generator=gen, device=DEVICE)
    depth = 2.0 + 30.0 * torch.rand(TB, TH, TW, 1, generator=gen,
                                    device=DEVICE)
    Km = torch.tensor([[0.8 * TW, 0.0, (TW - 1) / 2],
                       [0.0, 0.8 * TW, (TH - 1) / 2],
                       [0.0, 0.0, 1.0]], device=DEVICE).expand(TB, 3, 3)
    pose = 0.02 * torch.randn(TB, 6, generator=gen, device=DEVICE)
    coords = synthesis_coords(depth, Camera(Km, Tcw=Pose.from_vec(pose)),
                              Camera(Km)).contiguous()
    cx = exact_pixel_coords(TW)
    cy = exact_pixel_coords(TH)
    xs = torch.roll(cx, -3)[None, None, :].expand(TB, 8, TW)
    ys = cy[torch.isfinite(cy)][2:10][None, :, None].expand(TB, 8, TW)
    coords[:, 0:8, :, 0] = torch.nan_to_num(xs, nan=0.1)
    coords[:, 0:8, :, 1] = torch.nan_to_num(ys, nan=0.1)
    n_int = int((torch.isfinite(xs) & torch.isfinite(ys)).sum())
    coords[:, 8:16] = coords[:, 8:16] - 1.2 / (TW - 1)
    coords[:, 8:16, :, 1] = -1.0 - 0.3 * torch.rand(
        TB, 8, TW, generator=gen, device=DEVICE) * 2.0 / (TH - 1)
    coords[:, 16:24] = 1.6 + torch.rand(TB, 8, TW, 2, generator=gen,
                                        device=DEVICE)
    return image, coords.contiguous(), n_int


def phase_train_kernels(smi):
    """The warp and SSIM kernels against their plain versions at the
    training step's shapes; kernel, plain and library times."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    image, coords, n_int = warp_case(gen)
    got = warp_bilinear(image, coords)
    want = warp_bilinear_reference(image, coords)
    torch.cuda.synchronize()
    b, c, h, w = image.shape
    log(f"[kernel] warp_bilinear [{b},{c},{h},{w}], coords "
        f"{list(coords.shape)} ({n_int} integer pixel coords, "
        f"{int((coords.abs() > 1).any(-1).sum())} with a corner off the "
        f"image):")
    sx, sy = (w - 1) / 2, (h - 1) / 2
    # bit for bit by construction; a 1-ulp bar on the fields' scale is
    # the fallback the source states
    errs = [compare("out", got[0], want[0], 1e-6),
            compare("gx", got[1], want[1], 1e-6 * sx),
            compare("gy", got[2], want[2], 1e-6 * sy)]
    ms = cuda_ms(lambda: warp_bilinear(image, coords), iters=20)
    plain_ms = cuda_ms(lambda: warp_bilinear_reference(image, coords),
                       iters=3)
    grid = coords.clone().requires_grad_()
    lib_ms = cuda_ms(lambda: F.grid_sample(
        image, coords, mode="bilinear", padding_mode="zeros",
        align_corners=True), iters=20)
    gout = torch.rand(b, c, h, w, generator=gen, device=DEVICE)
    lib_fb_ms = cuda_ms(lambda: torch.autograd.grad(F.grid_sample(
        image, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), grid, gout), iters=10)
    lib_err = float((F.grid_sample(image, coords, mode="bilinear",
                                   padding_mode="zeros", align_corners=True)
                     - got[0]).abs().max())
    n_px = b * h * w
    w_bytes = image.numel() * 4 + coords.numel() * 4 + 3 * got[0].numel() * 4
    w_ops = n_px * (20 + 19 * c)
    w_bound, w_by = bound(w_bytes, w_ops)
    log(f"[kernel]   warp_bilinear {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {w_bound:.4f} ms ({w_by}: {w_bytes / 1e6:.1f} MB, "
        f"{w_ops / 1e9:.2f} G f32 ops); F.grid_sample forward "
        f"{lib_ms:.4f} ms (value max |diff| {lib_err:.2e}), forward + "
        f"backward to the grid {lib_fb_ms:.4f} ms; {smi}")
    rows = [dict(
        name="warp_bilinear", route="cuda",
        source="mgnet_tpu_torch/ops/csrc/warp.cu",
        replaces="mgnet_tpu/ops/pallas/warp.py:384",
        launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        bound_ms=w_bound, bound_by=w_by, library_ms=lib_ms,
        library_fwd_bwd_ms=lib_fb_ms)]

    x = got[0].contiguous()            # a warped frame, as on the path
    y = image
    r_got = ssim_residual_fwd(x, y, 0.85)
    r_want = ssim_residual_reference(x, y, 0.85)
    torch.cuda.synchronize()
    log(f"[kernel] ssim_residual_fwd [{b},{c},{h},{w}] -> [{b},{h},{w}]:")
    f_err = compare("residual", r_got, r_want, 0.0)
    f_ms = cuda_ms(lambda: ssim_residual_fwd(x, y, 0.85), iters=20)
    f_plain = cuda_ms(lambda: ssim_residual_reference(x, y, 0.85), iters=3)
    # x, y in once, r out once
    f_bytes = (2 * x.numel() + r_got.numel()) * 4
    f_ops = x.numel() * SSIM_FWD_OPS
    f_bound, f_by = bound(f_bytes, f_ops)
    log(f"[kernel]   ssim_residual_fwd {f_ms:.4f} ms, plain {f_plain:.4f} "
        f"ms, bound {f_bound:.4f} ms ({f_by}: {f_bytes / 1e6:.1f} MB, "
        f"{f_ops / 1e9:.2f} G f32 ops), {f_bound / f_ms:.3f} of it, "
        f"{f_bytes / f_ms / 1e9:.3f} TB/s; no single PyTorch call computes "
        f"it; {smi}")
    ssim_fwd_kitti(gen, smi)
    rows.append(dict(
        name="ssim_residual_fwd", route="cuda",
        source="mgnet_tpu_torch/ops/csrc/ssim.cu",
        replaces="mgnet_tpu/ops/pallas/ssim.py:144",
        launches=None, max_abs_err=f_err, ms=f_ms, plain_ms=f_plain,
        bound_ms=f_bound, bound_by=f_by, library_ms=None))

    g = torch.rand(b, h, w, generator=gen, device=DEVICE)
    d_got = ssim_residual_bwd(x, y, g, 0.85)
    d_want = ssim_residual_bwd_reference(x, y, g, 0.85)
    xr, yr = x.clone().requires_grad_(), y.clone().requires_grad_()
    d_auto = torch.autograd.grad(ssim_residual_reference(xr, yr, 0.85),
                                 (xr, yr), g)
    torch.cuda.synchronize()
    log(f"[kernel] ssim_residual_bwd [{b},{c},{h},{w}] + g [{b},{h},{w}]:")
    b_err = max(compare("dx vs plain", d_got[0], d_want[0], 0.0),
                compare("dy vs plain", d_got[1], d_want[1], 0.0))
    # the closed form against autograd of the plain forward: other
    # formulas, both in f32 (the CPU tests hold the closed form to f64
    # autograd within 1e-5; f32 autograd itself errs by ~5e-5 where
    # |dx| ~ 1, measured in a CPU rehearsal at [2, 3, 64, 64])
    compare("dx vs autograd", d_got[0], d_auto[0], 2e-4)
    compare("dy vs autograd", d_got[1], d_auto[1], 2e-4)
    b_ms = cuda_ms(lambda: ssim_residual_bwd(x, y, g, 0.85), iters=20)
    b_plain = cuda_ms(lambda: ssim_residual_bwd_reference(x, y, g, 0.85),
                      iters=3)
    # the least the function must move: x, y, g in once, dx, dy out; 153
    # f32 operations per pixel and channel, as csrc/ssim.cu's header
    # counts them. The kernel runs its blocks per (batch, channel)
    # plane and so reads g once per channel: its own traffic is logged
    b_bytes = (4 * x.numel() + g.numel()) * 4
    b_ops = x.numel() * 153
    b_bound, b_by = bound(b_bytes, b_ops)
    b_kernel_bytes = (4 * x.numel() + c * g.numel()) * 4
    log(f"[kernel]   ssim_residual_bwd {b_ms:.4f} ms, plain {b_plain:.4f} "
        f"ms, bound {b_bound:.4f} ms ({b_by}: {b_bytes / 1e6:.1f} MB, "
        f"{b_ops / 1e9:.2f} G f32 ops), {b_bound / b_ms:.3f} of it, "
        f"{b_bytes / b_ms / 1e6:.1f} GB/s; with g read once per channel "
        f"{b_kernel_bytes / 1e6:.1f} MB, {b_kernel_bytes / b_ms / 1e6:.1f} "
        f"GB/s; no single PyTorch call computes it; {smi}")
    rows.append(dict(
        name="ssim_residual_bwd", route="cuda",
        source="mgnet_tpu_torch/ops/csrc/ssim.cu",
        replaces="mgnet_tpu/ops/pallas/ssim.py:366",
        launches=None, max_abs_err=b_err, ms=b_ms, plain_ms=b_plain,
        bound_ms=b_bound, bound_by=b_by, library_ms=None))
    return rows


def ssim_fwd_kitti(gen, smi):
    """The SSIM forward at KITTI's training shape (uncropped 384x1280,
    configs/MGNet-KITTI-Eigen-Zhou.yaml), bit for bit and timed; its
    inputs fit in the 50 MB L2, so the timed launches cycle through four
    copies, as a caller that has just written other tensors would."""
    b, c, h, w = 2, 3, 384, 1280
    sets = []
    for _ in range(4):
        y = torch.rand(b, c, h, w, generator=gen, device=DEVICE)
        x = (y + 0.2 * torch.randn(b, c, h, w, generator=gen,
                                   device=DEVICE)).clamp(0, 1)
        sets.append((x, y))
    x, y = sets[0]
    got = ssim_residual_fwd(x, y, 0.85)
    want = ssim_residual_reference(x, y, 0.85)
    torch.cuda.synchronize()
    err = compare(f"residual at [{b},{c},{h},{w}]", got, want, 0.0)
    cycle = itertools.cycle(sets)
    ms = cuda_ms(lambda: ssim_residual_fwd(*next(cycle), 0.85), iters=40)
    n_bytes = (2 * x.numel() + got.numel()) * 4
    t_bound, by = bound(n_bytes, x.numel() * SSIM_FWD_OPS)
    log(f"[kernel]   ssim_residual_fwd at [{b},{c},{h},{w}]: {ms:.4f} ms, "
        f"bound {t_bound:.4f} ms ({by}: {n_bytes / 1e6:.1f} MB), "
        f"{t_bound / ms:.3f} of it, {n_bytes / ms / 1e9:.3f} TB/s, max "
        f"|diff| {err:.1e}; {smi}")


def train_config(dtype: str):
    cfg = apply_cityscapes_fine(get_default_config())
    cfg.MODEL.COMPUTE_DTYPE = dtype
    return cfg


def build_train(cfg, device):
    """Train state on ``device``: weights drawn on the CPU (so every device
    gets the same ones), both ResNet encoders from the ImageNet npz, the
    rest from a seeded generator."""
    model = build_model(cfg, device="cpu", for_training=True)
    init_random_(model, torch.Generator().manual_seed(SEED))
    npz = np.load(ROOT / "weights" / "imagenet_weights.npz")
    encoders = [("backbone/", model.backbone)]
    if hasattr(model, "pose_net"):
        encoders.append(("pose_net/encoder/", model.pose_net.encoder))
    for prefix, module in encoders:
        flat = {k[len(prefix):]: npz[k] for k in npz.files
                if k.startswith(prefix)}
        module.load_state_dict(load_jax_params(flat, module))
    model.to(device)
    return create_train_state(cfg, model)


def train_batch(b, h, w, device, num_classes=20):
    """The seeded synthetic batch on ``device``: classes 0-10 stuff, the
    rest of ``num_classes`` things."""
    batch = synthetic_train_batch(b, h, w, num_classes=num_classes,
                                  last_stuff_id=10, seed=SEED)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def counts():
    return {"warp_bilinear": warp_bilinear.launches,
            "ssim_residual_fwd": ssim_residual_fwd.launches,
            "ssim_residual_bwd": ssim_residual_bwd.launches}


def reset_counts():
    warp_bilinear.launches = 0
    ssim_residual_fwd.launches = 0
    ssim_residual_bwd.launches = 0


def expected_launches(cfg):
    """Kernel launches one training step of ``cfg`` implies: per
    micro-batch, with depth, the warp per context frame and scale (2 x 3),
    the SSIM forward per candidate (2 x (3 warped + 1 unwarped with
    automasking)), its backward per warped candidate (2 x 3); MODEL.REMAT
    runs the photometric loss's forward again in the backward. None
    without depth."""
    if not cfg.WITH_DEPTH:
        return dict.fromkeys(counts(), 0)
    dh = cfg.MODEL.DEPTH_HEAD
    warped = 2 * (3 if dh.MSC_LOSS else 1)
    fwd = warped + 2 * int(dh.AUTOMASK_LOSS)
    k = max(1, int(cfg.SOLVER.GRAD_ACCUM_STEPS))
    r = 2 if cfg.MODEL.REMAT else 1
    return {"warp_bilinear": k * r * warped,
            "ssim_residual_fwd": k * r * fwd,
            "ssim_residual_bwd": k * warped}


@contextlib.contextmanager
def last_kernel_calls():
    """Within the block, the training step's calls of the warp and SSIM
    wrappers go through the wrappers unchanged (and count as launches),
    and the last call of each is kept, cloned:
    {name: [calls so far, inputs, outputs]}."""
    sites = {"warp_bilinear": (geometry_image, "warp_bilinear"),
             "ssim_residual_fwd": (ops_ssim, "ssim_residual_fwd"),
             "ssim_residual_bwd": (ops_ssim, "ssim_residual_bwd")}
    kept = {}

    def clone(v):
        if isinstance(v, tuple):
            return tuple(clone(x) for x in v)
        return v.clone() if isinstance(v, torch.Tensor) else v

    def keeping(name, fn):
        def call(*args):
            out = fn(*args)
            n = kept[name][0] + 1 if name in kept else 1
            kept[name] = [n, clone(args), clone(out)]
            return out
        # a wrapper counts its launch through its module's global name,
        # which is now this function for the SSIM wrappers
        call.launches = 0
        return call

    wrappers = {name: getattr(mod, attr)
                for name, (mod, attr) in sites.items()}
    keepers = {name: keeping(name, fn) for name, fn in wrappers.items()}
    for name, (mod, attr) in sites.items():
        setattr(mod, attr, keepers[name])
    try:
        yield kept
    finally:
        for name, (mod, attr) in sites.items():
            setattr(mod, attr, wrappers[name])
            wrappers[name].launches += keepers[name].launches


def check_step_kernels(tag, cfg, state, batch):
    """One more (untimed) step of ``cfg`` with the last call of each
    training kernel kept (under MODEL.REMAT the warp's and the SSIM
    forward's last calls are the backward's recompute; under accumulation
    they are the last micro-batch's): each kernel's outputs held against
    its plain version on the same inputs, bit for bit."""
    with last_kernel_calls() as kept:
        make_train_step(cfg)(state, batch)
        torch.cuda.synchronize()
    check_kept_calls(tag, cfg, kept)
    del kept
    torch.cuda.empty_cache()


def check_kept_calls(tag, cfg, kept):
    """The last_kernel_calls() of one step of ``cfg``: as many as the step
    launches, each kernel's outputs equal to its plain version on the
    same inputs, bit for bit."""
    want = expected_launches(cfg)
    calls = {name: kept[name][0] if name in kept else 0 for name in want}
    if calls != want:
        raise AssertionError(f"{tag}: the kept calls {calls} are not the "
                             f"step's launches {want}")
    n, (image, coords, with_grads), got = kept["warp_bilinear"]
    ref = warp_bilinear_reference(image, coords, with_grads)
    b, c, h, w = image.shape
    log(f"[{tag}-kernels] warp_bilinear call {n} of {want['warp_bilinear']}"
        f" [{b},{c},{h},{w}], coords {list(coords.shape)}:")
    for name, g, r in zip(("out", "gx", "gy"), got, ref):
        if (g is None) != (r is None):
            raise AssertionError(f"{tag}: warp {name} is {g} against {r}")
        if g is not None:
            compare(name, g, r, 0.0, tag=f"{tag}-kernels")
    n, (x, y, weight), got = kept["ssim_residual_fwd"]
    log(f"[{tag}-kernels] ssim_residual_fwd call {n} of "
        f"{want['ssim_residual_fwd']} {list(x.shape)}:")
    compare("residual", got, ssim_residual_reference(x, y, weight), 0.0,
            tag=f"{tag}-kernels")
    n, (x, y, g, weight), got = kept["ssim_residual_bwd"]
    log(f"[{tag}-kernels] ssim_residual_bwd call {n} of "
        f"{want['ssim_residual_bwd']} {list(x.shape)}:")
    ref = ssim_residual_bwd_reference(x, y, g, weight)
    compare("dx", got[0], ref[0], 0.0, tag=f"{tag}-kernels")
    compare("dy", got[1], ref[1], 0.0, tag=f"{tag}-kernels")


def train_steps(tag, cfg, state, batch, warmup, steps, smi):
    """``warmup`` then ``steps`` timed training steps of ``cfg``: every loss
    printed and checked finite, every step's kernel launches checked
    against expected_launches(cfg). The counts are set to 0 after the
    warmup. Returns (the timed steps' launches, mean ms/step, peak GiB)."""
    step = make_train_step(cfg)
    want = expected_launches(cfg)
    b = batch["image"].shape[0]
    for i in range(warmup):
        t0 = time.perf_counter()
        _, m = step(state, batch)
        torch.cuda.synchronize()
        log(f"[{tag}] warmup step {i}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms, loss_total "
            f"{float(m['loss_total']):.5f}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms = []
    for i in range(steps):
        before = counts()
        t0 = time.perf_counter()
        _, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launched = {k: v - before[k] for k, v in counts().items()}
        losses = {k: float(v) for k, v in m.items()}
        bad = [k for k, v in losses.items() if not np.isfinite(v)]
        log(f"[{tag}] step {i}: {step_ms[-1]:.1f} ms, launches {launched}, "
            f"losses " + ", ".join(f"{k} {v:.6g}" for k, v in losses.items()))
        if bad:
            raise AssertionError(f"{tag} step {i}: non-finite {bad}")
        if launched != want:
            raise AssertionError(f"{tag} step {i}: kernel launches "
                                 f"{launched}, expected {want}")
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    mean = float(np.mean(step_ms))
    log(f"[{tag}] {steps} steps after {warmup} warmup: "
        f"{mean:.1f} ms/step (min {min(step_ms):.1f}, max "
        f"{max(step_ms):.1f}), {b * 1e3 / mean:.2f} images/s; peak "
        f"allocated {peak:.3f} GiB; launches per step {want}; {smi}")
    return launches, mean, peak


def phase_train(smi):
    """The joint training step at full width on the card: returns its
    kernel launches, the collectives its steps called (none at a world
    size of 1) and the profiler's launches per step."""
    cfg = train_config("bfloat16")
    t0 = time.perf_counter()
    state = build_train(cfg, DEVICE)
    batch = train_batch(TB, TH, TW, DEVICE)
    torch.cuda.synchronize()
    log(f"[train] Cityscapes-Fine recipe, bf16, batch {TB} of {TH}x{TW}: "
        f"{sum(p.numel() for p in state.params.parameters()) / 1e6:.2f} M "
        f"parameters, set-up {time.perf_counter() - t0:.1f} s")
    calls = COLLECTIVES["all_reduce"]
    launches, _, _ = train_steps("train", cfg, state, batch, TRAIN_WARMUP,
                                 TRAIN_STEPS, smi)
    calls = COLLECTIVES["all_reduce"] - calls
    per_step = train_breakdown(state, make_train_step(cfg), batch)
    return launches, calls, per_step


def train_breakdown(state, step, batch, tag="train"):
    """The profiler's device time by kernel over 2 steps, against their wall
    time: the device's busy and idle share."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n = 2
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.self_device_time_total / 1e3 / n, e.count / n, e.key)
            for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(r[0] for r in rows)
    log(f"[{tag}-breakdown] profiler: kernels busy {busy:.1f} of "
        f"{wall_ms:.1f} ms/step wall under the profiler (idle share "
        f"{1 - busy / wall_ms:.3f}); {sum(r[1] for r in rows):.0f} kernel "
        f"launches/step; top kernels:")
    for dev_ms, count, key in sorted(rows, reverse=True)[:15]:
        log(f"[{tag}-breakdown]   {dev_ms:8.3f} ms/step  x{count:6.1f}  "
            f"{key[:90]}")
    return sum(r[1] for r in rows)


def cosine_distance(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    den = float(a.norm() * b.norm())
    if den == 0.0:
        return 0.0 if torch.equal(a, b) else 1.0
    return 1.0 - float(a @ b) / den


def phase_cpu_vs_card_train(cfg=None, b=2, h=128, w=256,
                            tag="cpu-vs-card-train"):
    """One f32 training step on the card against the same step on the CPU
    (plain versions there), same weights and batch: by default the
    Fine recipe at batch 2 of 128x256."""
    cfg = train_config("float32") if cfg is None else cfg
    results = {}
    for device in ("cpu", DEVICE):
        state = build_train(cfg, device)
        _, m = make_train_step(cfg)(state, train_batch(b, h, w, device))
        results[device] = (
            {k: float(v) for k, v in m.items()},
            {n: p.grad.detach().cpu() for n, p in
             state.params.named_parameters()})
    (m_cpu, g_cpu), (m_card, g_card) = results["cpu"], results[DEVICE]
    rel = {k: abs(m_card[k] - v) / max(abs(v), 1e-6)
           for k, v in m_cpu.items()}
    loss_rel = {k: v for k, v in rel.items() if k.startswith("loss_")}
    dists = {n: cosine_distance(g_card[n], g) for n, g in g_cpu.items()}
    norms = {n: abs(float(g_card[n].norm()) / max(float(g.norm()), 1e-30)
                    - 1.0) for n, g in g_cpu.items()}
    worst = max(dists, key=dists.get)
    worst_norm = max(norms, key=norms.get)
    median = float(np.median(list(dists.values())))
    log(f"[{tag}] f32 step at {b}x{h}x{w}: losses "
        + ", ".join(f"{k} {m_cpu[k]:.6g}/{m_card[k]:.6g}" for k in m_cpu))
    log(f"[{tag}] max rel loss diff "
        f"{max(loss_rel.values()):.2e} ({max(loss_rel, key=loss_rel.get)}); "
        f"global gradient norm rel diff {rel['grad_norm']:.2e}; gradient "
        f"cosine distance over {len(dists)} tensors: worst "
        f"{dists[worst]:.2e} ({worst}), median {median:.2e}; worst "
        f"per-tensor norm ratio - 1: {norms[worst_norm]:.2e} "
        f"({worst_norm})")
    # f32 through two ResNet-18s, three decoders and the photometric warps
    # in other conv algorithms (cuDNN against oneDNN); at batch 2 the
    # pooled BN sites normalise over two values, which magnifies those
    # roundings in the gradient (the global norm moved by 3.6e-3 while the
    # losses agreed to 1e-6 on an H100). A wrong kernel, layout or weight
    # shows as O(1).
    if max(loss_rel.values()) > 1e-4:
        raise AssertionError("card and CPU training losses disagree")
    if dists[worst] > 1e-2 or median > 1e-4 or rel["grad_norm"] > 5e-2:
        raise AssertionError("card and CPU gradients disagree")


def build_slice(cfg, device, road_class_id=None,
                categories=CITYSCAPES_SCENE_SEG_CATEGORIES):
    """Model and fused frame of ``cfg``'s task branches on ``device``.
    Weights are drawn on the CPU (so every device gets the same ones):
    backbone from the ImageNet npz, GCM and heads from a seeded generator.
    ``road_class_id`` overrides the panoptic id that DGC takes as the
    ground."""
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(SEED))
    npz = np.load(ROOT / "weights" / "imagenet_weights.npz")
    flat = {k[len("backbone/"):]: npz[k] for k in npz.files
            if k.startswith("backbone/")}
    model.backbone.load_state_dict(load_jax_params(flat, model.backbone))
    model.to(device)
    meta = Metadata(name="cityscapes").set(**build_meta(categories))
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


def plain_panoptic(out, pp, argmin):
    """Panoptic fusion of a frame's head outputs, clustered by ``argmin``
    (the plain version, or a function that calls it)."""
    with torch.inference_mode():
        return panoptic_fusion(out["sem_seg"], out["center"], out["offset"],
                               **fusion_kwargs(pp), argmin=argmin)


def frame_shapes(cfg, h, w):
    """The frame's outputs for ``cfg``'s branches, with a camera: shape and
    dtype by key."""
    shapes = {}
    if cfg.WITH_PANOPTIC:
        shapes.update(sem_seg=((1, h, w), torch.int32),
                      panoptic=((1, h, w), torch.int32),
                      center=((1, h, w), torch.float32),
                      offset=((1, h, w, 2), torch.float32))
    if cfg.WITH_DEPTH:
        shapes.update(depth=((1, h, w), torch.float32),
                      points=((1, h, w, 3), torch.float32))
    return shapes


def check_frame(what, out, pp, shapes, captured):
    """One frame's outputs: keys, shapes and dtypes; finite depth and points
    where not filtered; at least one valid instance center; panoptic equal
    to the plain clustering on the same head outputs (whose inputs are
    appended to ``captured``)."""
    if set(out) != set(shapes):
        raise AssertionError(f"{what}: keys {sorted(out)}, expected "
                             f"{sorted(shapes)}")
    for key, (shape, dtype) in shapes.items():
        got = (tuple(out[key].shape), out[key].dtype)
        if got != (shape, dtype):
            raise AssertionError(f"{what}: {key} is {got}, expected "
                                 f"{(shape, dtype)}")
    pan = out["panoptic"]
    filtered = torch.zeros_like(pan, dtype=torch.bool)
    for cid in pp.depth_filter_ids:
        filtered |= pan == cid
    for key in ("depth", "points"):
        if key in out and not torch.isfinite(out[key][~filtered]).all():
            raise AssertionError(f"{what}: non-finite {key}")
    _, valid, _ = find_instance_centers(
        out["center"], pp.center_threshold, pp.nms_kernel, pp.max_instances)
    n_valid = int(valid.sum())
    if n_valid < 1:
        raise AssertionError(f"{what}: no valid instance center")

    def plain_argmin(*args):
        captured.append(args)
        return center_argmin_reference(*args)

    plain = plain_panoptic(out, pp, plain_argmin)
    if not torch.equal(plain, pan):
        raise AssertionError(
            f"{what}: panoptic differs from the plain clustering on "
            f"{int((plain != pan).sum())} pixels")
    n_inst = int(torch.unique(pan[pan % pp.label_divisor > 0]).numel())
    ground = float((pan == pp.road_class_id).float().mean())
    depth = (f", depth median {float(out['depth'][~filtered].median()):.4f}"
             if "depth" in out else "")
    log(f"[slice] {what}: valid centers {n_valid}, instances {n_inst}, "
        f"ground share {ground:.4f}, filtered share "
        f"{float(filtered.float().mean()):.4f}{depth}; panoptic == plain "
        f"clustering")


def phase_slice(smi, parent=None):
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

    captured = []
    for i, out in enumerate(outs):
        check_frame(f"request {i}", out, statics, frame_shapes(cfg, H, W),
                    captured)
    center_argmin_report("B", captured[0], smi, parent)

    steady_frame("slice", fused, requests[0], 10, 50, smi)
    breakdown(fused, model, cfg, requests[0], smi)
    return launches


def steady_frame(tag, fused, req, warmup, n, smi):
    """Host-clock time of the frame on one request, image on the card,
    after ``warmup`` frames; peak memory over the ``n`` timed ones."""
    for _ in range(warmup):
        fused(*req)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        fused(*req)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, h, w, _ = req[0].shape
    log(f"[{tag}] steady frame (1x{h}x{w}, bf16, image on the card): "
        f"{ms:.3f} ms/frame, {1e3 / ms:.2f} fps over {n} frames after "
        f"{warmup} warmup; peak allocated {peak:.3f} GiB; {smi}")
    return ms


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


def shipped(name, *opts):
    return load_config(str(CONFIG_DIR / name), list(opts))


def config_train(tag, cfg, batch, smi, profile=False):
    """The training step of ``cfg`` on ``batch``: set-up, then
    train_steps, then with depth check_step_kernels, then with ``profile``
    train_breakdown; frees the state after."""
    t0 = time.perf_counter()
    state = build_train(cfg, DEVICE)
    torch.cuda.synchronize()
    b, h, w, _ = batch["image"].shape
    log(f"[{tag}] batch {b} of {h}x{w}, {cfg.MODEL.COMPUTE_DTYPE}, "
        f"{cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES} classes, WITH_DEPTH "
        f"{cfg.WITH_DEPTH}, GRAD_ACCUM_STEPS {cfg.SOLVER.GRAD_ACCUM_STEPS}, "
        f"REMAT {cfg.MODEL.REMAT}, {cfg.SOLVER.OPTIMIZER}: "
        f"{sum(p.numel() for p in state.params.parameters()) / 1e6:.2f} M "
        f"parameters, set-up {time.perf_counter() - t0:.1f} s")
    launches, _, _ = train_steps(tag, cfg, state, batch, CFG_WARMUP,
                                 CFG_STEPS, smi)
    if cfg.WITH_DEPTH:
        check_step_kernels(tag, cfg, state, batch)
    if profile:
        train_breakdown(state, make_train_step(cfg), batch, tag)
    del state
    torch.cuda.empty_cache()
    return launches


def config_frame(tag, cfg, categories, h, w, smi):
    """The fused frame of ``cfg`` at 1 x h x w: one request with its
    center_argmin launches counted (from 0) and its outputs checked, then
    the steady frame time."""
    fused, statics, _ = build_slice(cfg, DEVICE, categories=categories)
    req = request(0, h, w, DEVICE)
    torch.cuda.synchronize()
    center_argmin.launches = 0
    out = fused(*req)
    torch.cuda.synchronize()
    launches = center_argmin.launches
    log(f"[{tag}] 1 request at {h}x{w} bf16, {statics.num_classes} classes, "
        f"keys {sorted(out)}: center_argmin launches {launches}")
    if launches != 1:
        raise AssertionError(f"{tag}: center_argmin launched {launches} "
                             f"times for one frame")
    check_frame(tag, out, statics, frame_shapes(cfg, h, w), [])
    steady_frame(tag, fused, req, FRAME_WARMUP, FRAME_ITERS, smi)
    return launches


def phase_configs(smi):
    """Every shipped configs/*.yaml through the port's load_config, its
    training step at the recipe's batch and its fused frame; returns the
    training paths' launches by kernel and the frames' center_argmin
    launches, each by path."""
    trees = {p.name: load_config(str(p)).to_dict()
             for p in sorted(CONFIG_DIR.glob("*.yaml"))}
    log(f"[configs] loaded {len(trees)} files: {sorted(trees)}")
    if len(trees) != 5:
        raise AssertionError(f"expected the 5 shipped configs, got {trees}")

    def flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + k + "."))
            else:
                out[prefix + k] = v
        return out

    fine = flat(trees["MGNet-Cityscapes-Fine.yaml"])
    video = flat(trees["MGNet-Cityscapes-VideoSequence.yaml"])
    differ = sorted(k for k in fine if fine[k] != video[k])
    log(f"[configs] VideoSequence differs from Fine in {differ}")
    if differ != ["DATASETS.TRAIN"]:
        raise AssertionError(f"VideoSequence differs from Fine in {differ}")

    paths, frames = {}, {}
    fine_name = "MGNet-Cityscapes-Fine.yaml"
    crop = tuple(shipped(fine_name).INPUT.CROP.SIZE)
    batch = train_batch(CFG_BATCH, *crop, DEVICE)
    for tag, opts in (("fine-b12", ()),
                      ("fine-b12-accum3", ("SOLVER.GRAD_ACCUM_STEPS", "3")),
                      ("fine-b12-remat", ("MODEL.REMAT", "True"))):
        paths[tag] = config_train(tag, shipped(fine_name, *opts), batch, smi,
                                  profile=not opts)
    pan_name = "MGNet-Cityscapes-PseudoLabelGeneration.yaml"
    paths["panoptic-b12"] = config_train("panoptic-b12", shipped(pan_name),
                                         batch, smi)
    if any(paths["panoptic-b12"].values()):
        raise AssertionError("the panoptic-only step launched a warp or "
                             f"SSIM kernel: {paths['panoptic-b12']}")
    del batch
    kitti_name = "MGNet-KITTI-Eigen-Zhou.yaml"
    kitti = shipped(kitti_name)
    batch = train_batch(CFG_BATCH, KH, KW, DEVICE,
                        num_classes=kitti.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
    paths["kitti-b12"] = config_train("kitti-b12", kitti, batch, smi)
    del batch
    torch.cuda.empty_cache()

    # KITTI's 19 classes as mgnet_tpu/data/kitti.py registers them (the
    # pseudo-label configs keep the 20 scene-seg classes)
    frames["kitti-frame"] = config_frame(
        "kitti-frame", kitti, CITYSCAPES_CATEGORIES, KH, KW, smi)
    frames["panoptic-frame"] = config_frame(
        "panoptic-frame", shipped(pan_name),
        CITYSCAPES_SCENE_SEG_CATEGORIES, H, W, smi)
    frames["kitti-panoptic-frame"] = config_frame(
        "kitti-panoptic-frame",
        shipped("MGNet-KITTI-Eigen-PseudoLabelGeneration.yaml"),
        CITYSCAPES_SCENE_SEG_CATEGORIES, KH, KW, smi)

    phase_cpu_vs_card_train(
        shipped(fine_name, "MODEL.COMPUTE_DTYPE", "float32",
                "SOLVER.GRAD_ACCUM_STEPS", "2", "MODEL.REMAT", "True",
                "SOLVER.OPTIMIZER", "SGD", "MODEL.BACKBONE.FREEZE_AT", "2",
                "SOLVER.LR_SCHEDULER_NAME", "WarmupCosineLR"),
        SMALL_B, SMALL_H, SMALL_W, tag="cpu-vs-card-train-options")
    return paths, frames


def host_ops_check(written, h, w):
    """The host library against its numpy versions on this host: the
    unfilter of the first frame's first rows under all five filters, and
    the Fine recipe's largest resize (h x w -> 2h x 2w) and a downscale
    (-> h/2 x w/2), bilinear on the frame, nearest on its label."""
    frame = next(a for p, a in written.items() if "leftImg8bit/" in str(p))
    label = next(a for p, a in written.items() if "panoptic" in str(p))
    rows = frame[:16].reshape(16, -1)
    stream = png_filter_reference(rows, 3, [y % 5 for y in range(16)])
    t0 = time.perf_counter()
    got = png_unfilter(stream.tobytes(), 16, rows.shape[1], 3)
    cpp_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = png_unfilter_reference(stream.tobytes(), 16, rows.shape[1], 3)
    ref_ms = (time.perf_counter() - t0) * 1e3
    if not (np.array_equal(got, want) and np.array_equal(got, rows)):
        raise AssertionError("the C++ unfilter disagrees with numpy")
    log(f"[trainer-host] unfilter 16 x {w} RGB rows, filters 0-4: C++ equals"
        f" numpy and the rows; {cpp_ms:.2f} ms against numpy's "
        f"{ref_ms:.1f} ms (host clock)")
    for (oh, ow) in ((2 * h, 2 * w), (h // 2, w // 2)):
        for name, img, cpp, ref in (
                ("bilinear", frame, resize_bilinear,
                 resize_bilinear_reference),
                ("nearest", label, resize_nearest,
                 resize_nearest_reference)):
            t0 = time.perf_counter()
            got = cpp(img, oh, ow)
            cpp_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            want = ref(img, oh, ow)
            ref_ms = (time.perf_counter() - t0) * 1e3
            if not np.array_equal(got, want):
                raise AssertionError(f"the C++ {name} resample {h}x{w} -> "
                                     f"{oh}x{ow} disagrees with numpy")
            log(f"[trainer-host] {name} {h}x{w}x3 -> {oh}x{ow}: C++ equals "
                f"numpy bit for bit; {cpp_ms:.1f} ms against numpy's "
                f"{ref_ms:.1f} ms (host clock)")


def trainer_argv(root: Path, out: Path, iters: int, *flags,
                 eval_period: int = 0):
    return ["--config-file", str(CONFIG_DIR / "MGNet-Cityscapes-Fine.yaml"),
            "--data-root", str(root), "--device", DEVICE, *flags,
            "SOLVER.MAX_ITER", str(iters), "SOLVER.CHECKPOINT_PERIOD", "2",
            "TEST.EVAL_PERIOD", str(eval_period), "OUTPUT_DIR", str(out),
            "WRITE_OUTPUT_TO_SUBDIR", "False", "MODEL.WEIGHTS",
            str(ROOT / "weights" / "imagenet_weights.npz"), *TRAINER_OPTS]


@contextlib.contextmanager
def recorded_steps():
    """Within the block, every training step that trainer.py makes keeps
    its kernel launches, its metrics (read on the host: one sync a step)
    and its batch: a list of (launches, metrics, batch)."""
    steps = []
    make = trainer_module.make_train_step

    def recording(cfg):
        step = make(cfg)

        def call(state, batch):
            before = counts()
            state, metrics = step(state, batch)
            host = {k: float(v) for k, v in metrics.items()}
            steps.append(({k: v - before[k] for k, v in counts().items()},
                          host, batch))
            return state, metrics
        return call

    trainer_module.make_train_step = recording
    try:
        yield steps
    finally:
        trainer_module.make_train_step = make


def check_trainer_steps(tag, cfg, steps, n):
    want = expected_launches(cfg)
    if len(steps) != n:
        raise AssertionError(f"{tag}: {len(steps)} steps, expected {n}")
    for i, (launched, metrics, _) in enumerate(steps):
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        log(f"[{tag}] step {i}: launches {launched}, loss_total "
            f"{metrics['loss_total']:.6g}, " + ", ".join(
                f"{k} {v:.5g}" for k, v in metrics.items()
                if k.endswith("_raw")))
        if bad:
            raise AssertionError(f"{tag} step {i}: non-finite {bad}")
        if launched != want:
            raise AssertionError(f"{tag} step {i}: kernel launches "
                                 f"{launched}, expected {want}")


def same_state(state, payload) -> int:
    """Raises unless ``state`` equals a checkpoint's payload bit for bit;
    returns the number of tensors compared."""
    n = 0
    params = state.params.state_dict()
    if params.keys() != payload["params"].keys():
        raise AssertionError("restored parameter names differ")
    for k, v in payload["params"].items():
        if not torch.equal(params[k].cpu(), v.cpu()):
            raise AssertionError(f"restored {k} differs from the checkpoint")
        n += 1
    opt = state.optimizer.state_dict()
    want = payload["optimizer"]
    if opt["names"] != want["names"] or opt["count"] != want["count"]:
        raise AssertionError("restored optimizer names or count differ")
    for a, b in zip(opt["mu"] + opt["nu"], want["mu"] + want["nu"]):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError("a restored optimizer moment differs")
        n += 1
    if state.step != payload["step"]:
        raise AssertionError(f"restored step {state.step}, checkpoint "
                             f"{payload['step']}")
    return n


MAPPER_STAGES = ("read_png", "resize+crop", "jitter", "targets")


@contextlib.contextmanager
def mapper_stages(mapper):
    """Within the block, ``mapper``'s calls add their host seconds by stage
    to the dict it yields: the PNG reads (read_png: inflate and unfilter),
    the resize + crop of the frames and the label, the colour jitter of
    the frames, and the targets (rgb2id and the target generator)."""
    spent = dict.fromkeys(MAPPER_STAGES, 0.0)

    def timed(stage, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[stage] += time.perf_counter() - t0
        return call

    sampler, jitter = mapper.sampler, mapper_module.sample_color_jitter
    rgb2id = mapper_module.rgb2id

    def sample(rng, shape):
        tfl = sampler(rng, shape)
        tfl.apply_image = timed("resize+crop", tfl.apply_image)
        tfl.apply_segmentation = timed("resize+crop", tfl.apply_segmentation)
        return tfl

    def sample_jitter(*args):
        j = jitter(*args)
        j.apply_image = timed("jitter", j.apply_image)
        return j

    mapper._read = timed("read_png", mapper._read)
    mapper.sampler = sample
    mapper.target_gen = timed("targets", mapper.target_gen)
    mapper_module.sample_color_jitter = sample_jitter
    mapper_module.rgb2id = timed("targets", rgb2id)
    try:
        yield spent
    finally:
        mapper_module.sample_color_jitter = jitter
        mapper_module.rgb2id = rgb2id


def loader_rates(cfg, batches: int):
    """The mapper's ms/sample on one thread, in all and by stage, and the
    loader's samples/s with the config's workers and nothing else running
    (host clock)."""
    name = cfg.DATASETS.TRAIN[0]
    dicts = DatasetCatalog.get(name)
    n = min(4, len(dicts))
    mapper = TrainDatasetMapper(cfg, dataset_name=name)
    with mapper_stages(mapper) as spent:
        t0 = time.perf_counter()
        for j, d in enumerate(dicts[:n]):
            mapper(d, rng=np.random.default_rng((SEED, 99, j)))
        mapper_ms = (time.perf_counter() - t0) / n * 1e3
    stages_ms = {k: v / n * 1e3 for k, v in spent.items()}
    loader = TrainLoader(dicts, TrainDatasetMapper(cfg, dataset_name=name),
                         cfg.SOLVER.IMS_PER_BATCH, seed=1,
                         num_workers=cfg.DATALOADER.NUM_WORKERS,
                         prefetch=cfg.DATALOADER.PREFETCH,
                         pin_memory=DEVICE != "cpu")
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    rate = batches * cfg.SOLVER.IMS_PER_BATCH / (time.perf_counter() - t0)
    loader.close()
    return mapper_ms, stages_ms, rate


def phase_trainer(smi, root: Path):
    """tools/train_net.py from the Fine YAML on a tree written under
    ``root`` (with its val split): the host library checked,
    TRAINER_ITERS trainer iterations at the recipe's batch with
    checkpoints, then a resume for TRAINER_RESUME more whose last ends in
    Trainer.test; returns each run's kernel launches (counts from 0 just
    before it), the resume's center_argmin launches included."""
    out = root / "out"
    t0 = time.perf_counter()
    written = {Path(p): a for p, a in write_cityscapes_tree(
        str(root), TREE_FRAMES, TREE_H, TREE_W, seed=SEED,
        val_sizes=VAL_SIZES).items()}
    log(f"[trainer] wrote {len(written)} PNGs ({TREE_FRAMES} frames at "
        f"{TREE_H}x{TREE_W}, each with itself and its -/+1 frames in the "
        f"sequence directory, panoptic labels; val "
        f"frames {list(VAL_SIZES)} with panoptic labels and 16-bit "
        f"disparity) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for path, arr in written.items():
        if not np.array_equal(read_png(path), arr):
            raise AssertionError(f"{path}: read_png differs from what "
                                 "write_png wrote")
    log(f"[trainer] read_png of all {len(written)} equals what was "
        f"written ({time.perf_counter() - t0:.1f} s, one thread)")
    host_ops_check(written, TREE_H, TREE_W)

    if DEVICE != "cpu":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with recorded_steps() as steps:
        trainer = train_net.main(trainer_argv(root, out, TRAINER_ITERS))
    wall = time.perf_counter() - t0
    launches = counts()
    cfg = trainer.cfg
    b = cfg.SOLVER.IMS_PER_BATCH
    crop = tuple(cfg.INPUT.CROP.SIZE)
    log(f"[trainer] train_net on {cfg.DATASETS.TRAIN[0]}: batch "
        f"{b} of {crop[0]}x{crop[1]} crops, {cfg.MODEL.COMPUTE_DTYPE}, "
        f"{cfg.DATALOADER.NUM_WORKERS} loader threads, npz graft "
        f"{trainer.pretrained}; {TRAINER_ITERS} iterations, "
        f"{wall:.1f} s with set-up")
    check_trainer_steps("trainer", cfg, steps, TRAINER_ITERS)
    if not trainer.pretrained or trainer.pretrained["matched"] <= 0:
        raise AssertionError(f"npz graft matched {trainer.pretrained}")
    ckpts = CheckpointManager(str(out / "checkpoints")).steps()
    final = out / "model_final" / "params.pt"
    log(f"[trainer] checkpoints {ckpts}, model_final "
        f"{final.is_file()}, launches {launches}")
    if ckpts != [2, TRAINER_ITERS] or not final.is_file():
        raise AssertionError("missing checkpoints or model_final")
    iter_ms = [s * 1e3 for s in trainer.iter_seconds]
    wait_ms = [s * 1e3 for s in trainer.data_seconds]
    save_ms = [s * 1e3 for s in trainer.save_seconds]
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if DEVICE != "cpu" else float("nan"))

    payload = torch.load(out / "checkpoints" / f"{TRAINER_ITERS}.pt",
                         map_location="cpu", weights_only=True)
    n_iters = TRAINER_ITERS + TRAINER_RESUME
    args = train_net.parse_args(trainer_argv(root, out, n_iters,
                                             "--resume",
                                             eval_period=n_iters))
    with recorded_steps() as resume_steps:
        resumed = Trainer(train_net.setup(args), device=DEVICE)
    resumed.resume_or_load(resume=True)
    n = same_state(resumed.state, payload)
    n_mem = same_state(resumed.state, {
        "params": trainer.state.params.state_dict(),
        "optimizer": trainer.state.optimizer.state_dict(),
        "step": trainer.state.step})
    log(f"[trainer-resume] restored step {resumed.state.step}: {n} "
        f"tensors (parameters, BN statistics, Adam moments) and count "
        f"{resumed.state.optimizer.count} equal the checkpoint bit for "
        f"bit ({n_mem} equal the first run's state in memory)")
    del payload, trainer
    reset_counts()
    center_argmin.launches = 0
    resumed.train()
    resume_launches = {**counts(), "center_argmin": center_argmin.launches}
    check_trainer_steps("trainer-resume", resumed.cfg, resume_steps,
                        TRAINER_RESUME)
    ckpts = CheckpointManager(str(out / "checkpoints")).steps()
    if resumed.state.step != n_iters or ckpts[-1] != n_iters:
        raise AssertionError(f"resume ended at step "
                             f"{resumed.state.step}, checkpoints {ckpts}")
    log(f"[trainer-resume] {TRAINER_RESUME} more iterations to step "
        f"{resumed.state.step}, checkpoints {ckpts}, launches "
        f"{resume_launches}")
    check_trainer_eval(resumed, out, n_iters)
    # the same step on the run's last batch with no loader running (the
    # step beside loader threads was measured until the validation phase
    # came: PERF.md, calls R4 and R5)
    step, batch = make_train_step(resumed.cfg), resume_steps[-1][2]
    cores = len(os.sched_getaffinity(0))
    step_ms = steady_state_timer(step, (resumed.state, batch), warmup=1,
                                 iters=STEP_ITERS) * 1e3
    del resumed, resume_steps, batch
    if DEVICE != "cpu":
        torch.cuda.empty_cache()

    mapper_ms, stages_ms, rate = loader_rates(cfg, LOADER_BATCHES)
    rest_ms = [t - w - c for t, w, c in zip(iter_ms, wait_ms, save_ms)]
    steady = [t - c for t, c in zip(iter_ms[1:], save_ms[1:])]
    fmt = ", ".join
    log(f"[trainer] per iteration (ms, host clock): in all "
        f"[{fmt(f'{t:.1f}' for t in iter_ms)}]; waiting on next(loader) "
        f"[{fmt(f'{t:.1f}' for t in wait_ms)}]; writing a checkpoint "
        f"[{fmt(f'{t:.1f}' for t in save_ms)}]; the step and the rest "
        f"[{fmt(f'{t:.1f}' for t in rest_ms)}]. After the first, "
        f"without the checkpoint writes: {np.mean(steady):.1f} ms "
        f"(min {min(steady):.1f}, max {max(steady):.1f})")
    log(f"[trainer] the step on the run's last batch ({STEP_ITERS} "
        f"after 1 warmup, synchronised after each): {step_ms:.1f} ms with "
        f"no loader running")
    log(f"[trainer] mapper on one thread {mapper_ms:.1f} ms/sample: "
        + fmt(f"{k} {v:.1f}" for k, v in stages_ms.items())
        + f", other {mapper_ms - sum(stages_ms.values()):.1f}; host "
        f"os.cpu_count() {os.cpu_count()}, usable cores {cores}; loader {rate:.2f} samples/s "
        f"with {cfg.DATALOADER.NUM_WORKERS} threads and nothing else "
        f"running, against the {b * 1e3 / step_ms:.2f} the step "
        f"alone consumes; peak allocated {peak:.3f} GiB ({smi})")
    return launches, resume_launches


def expected_eval_groups(cfg):
    """The result groups the JAX evaluators give for ``cfg``, in order."""
    groups = []
    if cfg.WITH_PANOPTIC:
        groups.append("panoptic_seg")
        if cfg.TEST.EVAL_SEMANTIC:
            groups.append("sem_seg")
    if cfg.WITH_DEPTH:
        groups.append("depth")
    if cfg.TEST.EVAL_INSTANCE:
        groups.append("instances")
    return groups + ["eval_speed"]


def check_eval_results(tag, cfg, results):
    """The JAX evaluators' key set for ``cfg``, every value finite."""
    want = expected_eval_groups(cfg)
    if list(results) != want:
        raise AssertionError(f"{tag}: result groups {list(results)}, "
                             f"expected {want}")
    heads = {"panoptic_seg": PANOPTIC_KEYS,
             "sem_seg": ["mIoU", "IoU", "iIoU", "IoU_sup", "iIoU_sup"],
             "depth": DEPTH_KEYS, "instances": ["AP", "AP50"],
             "eval_speed": ["images_per_s", "num_images"]
             + (["peak_hbm_gb"] if DEVICE != "cpu" else [])}
    for group, keys in heads.items():
        if group in results and list(results[group])[:len(keys)] != keys:
            raise AssertionError(f"{tag}: {group} keys "
                                 f"{list(results[group])}, expected {keys}")
    if "instances" in results and list(results["instances"])[-2:] != [
            "num_images", "num_instances"]:
        raise AssertionError(f"{tag}: instance counts missing")
    bad = [f"{g}/{k}" for g, d in results.items() for k, v in d.items()
           if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{tag}: non-finite metrics {bad}")


def eval_batches(sizes, batch: int) -> int:
    """Device batches of evaluate_dataset over frames of ``sizes``: one
    bucket key per original size (the test mapper gives every size here
    the same valid shape), each full batch and one tail."""
    n = defaultdict(int)
    for hw in sizes:
        n[hw] += 1
    return sum(math.ceil(k / batch) for k in n.values())


def check_trainer_eval(trainer, out: Path, step: int):
    """Trainer.test ran once, at ``step``: its metrics under eval/ in
    metrics.json, finite, and its seconds apart from the iteration's
    others."""
    lines = [json.loads(line) for line in
             (out / "metrics.json").read_text().splitlines()]
    evals = [r for r in lines if any(k.startswith("eval/") for k in r)]
    if len(evals) != 1 or evals[0]["iteration"] != step:
        raise AssertionError(f"trainer eval: {len(evals)} eval lines in "
                             "metrics.json, expected one at step {step}")
    metrics = {k: v for k, v in evals[0].items() if k.startswith("eval/")}
    groups = sorted({k.split("/")[1] for k in metrics})
    want = sorted(expected_eval_groups(trainer.cfg))
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    if groups != want or bad:
        raise AssertionError(f"trainer eval: groups {groups} (expected "
                             f"{want}), non-finite {bad}")
    eval_s = trainer.eval_seconds
    if eval_s[-1] <= 0 or any(eval_s[:-1]):
        raise AssertionError(f"trainer eval seconds {eval_s}")
    rest = [(t - e) * 1e3 for t, e in zip(trainer.iter_seconds, eval_s)]
    log(f"[trainer-eval] Trainer.test at step {step}: "
        f"{metrics['eval/eval_speed/num_images']:.0f} images, "
        f"{metrics['eval/eval_speed/images_per_s']:.3f} images/s, "
        f"{eval_s[-1]:.2f} s; PQ {metrics['eval/panoptic_seg/PQ']:.4f}, "
        f"mIoU {metrics['eval/sem_seg/mIoU']:.4f}, Abs Rel "
        f"{metrics['eval/depth/Abs Rel']:.4f}; iterations without the eval "
        f"[{', '.join(f'{t:.1f}' for t in rest)}] ms")


@contextlib.contextmanager
def eval_probe(timed: bool = False):
    """Within the block, evaluate_dataset's device batches are counted
    (``to_host`` runs once per batch) and the last center_argmin inputs of
    each [B, H, W] are kept, cloned; with ``timed``, each batch's stages
    are timed on the host clock with the card synchronised at each
    boundary (the eval step; the post-processing: resize to the original
    size, argmax, fusion, depth, compaction; the copy to the host) and the
    host's per-call time of each evaluator's ``process``, of
    ``extract_instances`` and of the GT PNG reads."""
    rec = {"batches": 0, "argmin": {}, "stage_ms": defaultdict(list),
           "host_ms": defaultdict(list)}
    marks = {}
    argmin = panoptic_fusion.__kwdefaults__["argmin"]
    originals = {name: getattr(trainer_module, name) for name in
                 ("make_eval_step", "_make_tta_step", "to_host",
                  "extract_instances", "read_image")}
    read_gt_depth = eval_depth.read_png
    methods = {cls: cls.process for cls in (
        PanopticEvaluator, SemSegEvaluator, DepthEvaluator,
        InstanceAPEvaluator)}

    def host_timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                rec["host_ms"][name].append(
                    (time.perf_counter() - t0) * 1e3)
        return call if timed else fn

    def stepping(make):
        def build(cfg):
            step = make(cfg)

            def call(model, images):
                if not timed:
                    return step(model, images)
                sync()
                t0 = time.perf_counter()
                out = step(model, images)
                sync()
                marks["step"] = time.perf_counter()
                rec["stage_ms"]["eval step"].append(
                    (marks["step"] - t0) * 1e3)
                return out
            return call
        return build

    def hosting(res):
        rec["batches"] += 1
        if not timed:
            return originals["to_host"](res)
        sync()
        t0 = time.perf_counter()
        rec["stage_ms"]["post-processing"].append((t0 - marks["step"]) * 1e3)
        out = originals["to_host"](res)
        rec["stage_ms"]["copy to host"].append(
            (time.perf_counter() - t0) * 1e3)
        return out

    def keeping(*args):
        rec["argmin"][tuple(args[0].shape)] = tuple(a.clone() for a in args)
        return argmin(*args)

    trainer_module.make_eval_step = stepping(originals["make_eval_step"])
    trainer_module._make_tta_step = stepping(originals["_make_tta_step"])
    trainer_module.to_host = hosting
    trainer_module.extract_instances = host_timed(
        "extract_instances", originals["extract_instances"])
    trainer_module.read_image = host_timed("read_image (GT panoptic, "
                                           "visualized image)",
                                           originals["read_image"])
    eval_depth.read_png = host_timed("read_png (GT disparity)",
                                     read_gt_depth)
    for cls, fn in methods.items():
        cls.process = host_timed(f"{cls.__name__}.process", fn)
    panoptic_fusion.__kwdefaults__["argmin"] = keeping
    try:
        yield rec
    finally:
        for name, fn in originals.items():
            setattr(trainer_module, name, fn)
        eval_depth.read_png = read_gt_depth
        for cls, fn in methods.items():
            cls.process = fn
        panoptic_fusion.__kwdefaults__["argmin"] = argmin


def eval_only(tag, config: str, root: Path, out: Path, *opts,
              timed=False):
    """train_net --eval-only of ``config`` on the tree under ``root``, with
    the device batches and center_argmin launches counted from 0: returns
    (results, the probe's record, center_argmin launches, config)."""
    argv = ["--config-file", str(CONFIG_DIR / config), "--data-root",
            str(root), "--device", DEVICE, "--eval-only", "OUTPUT_DIR",
            str(out), *opts, *EVAL_OPTS]
    cfg = load_config(str(CONFIG_DIR / config), [*opts, *EVAL_OPTS])
    if DEVICE != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    center_argmin.launches = 0
    t0 = time.perf_counter()
    with eval_probe(timed) as rec:
        results = train_net.main(argv)
    wall = time.perf_counter() - t0
    launches = center_argmin.launches
    check_eval_results(tag, cfg, results)
    lines = (out / "metrics.json").read_text().splitlines()
    if [json.loads(line) for line in lines] != [
            json.loads(json.dumps(results))]:
        raise AssertionError(f"{tag}: metrics.json differs from the "
                             "results")
    batch = (cfg.TEST.TTA_IMS_PER_BATCH if cfg.TEST.MSC_FLIP_EVAL
             else cfg.TEST.IMS_PER_BATCH)
    want = eval_batches(VAL_SIZES, batch)
    speed = results["eval_speed"]
    log(f"[{tag}] {config} --eval-only ({cfg.MODEL.COMPUTE_DTYPE}, batch "
        f"{batch}, {cfg.DATALOADER.NUM_WORKERS} mapping threads, "
        f"MSC_FLIP_EVAL {cfg.TEST.MSC_FLIP_EVAL}, EVAL_INSTANCE "
        f"{cfg.TEST.EVAL_INSTANCE}): {speed['num_images']:.0f} images, "
        f"{speed['images_per_s']:.3f} images/s, {wall:.1f} s with set-up; "
        f"device batches {rec['batches']} (expected {want}), center_argmin "
        f"launches {launches}; peak allocated "
        f"{speed.get('peak_hbm_gb', float('nan')):.3f} GiB; groups "
        f"{list(results)}, all finite, metrics.json the same")
    if not rec["batches"] == launches == want:
        raise AssertionError(f"{tag}: {launches} center_argmin launches for "
                             f"{rec['batches']} device batches, expected "
                             f"{want}")
    return results, rec, launches, cfg


def log_eval_timings(tag, rec, smi):
    fmt = ", ".join
    log(f"[{tag}-timing] per device batch (ms, host clock, card "
        f"synchronised at each boundary): " + "; ".join(
            f"{k} [{fmt(f'{t:.1f}' for t in v)}]"
            for k, v in rec["stage_ms"].items()) + f"; {smi}")
    log(f"[{tag}-timing] host ms per call (one per sample; the reads also "
        f"per visualized image): " + "; ".join(
            f"{k} {np.mean(v):.1f} (x{len(v)})"
            for k, v in rec["host_ms"].items()))


def phase_eval(smi, root: Path):
    """train_net --eval-only over the trainer tree's val split: the Fine
    YAML with the trainer's model_final, without instances, with
    instances, then the pseudo-label YAML's TTA from the ImageNet npz;
    every run timed by stage (the runs with 1 and cores - 1 mapping
    threads were measured until the validation phase came: PERF.md);
    returns the center_argmin launches by run."""
    model_final = str(root / "out" / "model_final")
    fine = "MGNet-Cityscapes-Fine.yaml"
    launches = {}
    _, rec, launches["eval"], _ = eval_only(
        "eval", fine, root, root / "eval", "MODEL.WEIGHTS", model_final,
        "TEST.EVAL_INSTANCE", "False", timed=True)
    log_eval_timings("eval", rec, smi)
    for shape, args in sorted(rec["argmin"].items()):
        center_argmin_report("eval-" + "x".join(map(str, shape)), args, smi,
                             None)
    _, rec, launches["eval-instances"], _ = eval_only(
        "eval-instances", fine, root, root / "eval_instances",
        "MODEL.WEIGHTS", model_final, "TEST.EVAL_INSTANCE", "True",
        timed=True)
    log_eval_timings("eval-instances", rec, smi)
    npz = str(ROOT / "weights" / "imagenet_weights.npz")
    _, rec, launches["eval-tta"], cfg = eval_only(
        "eval-tta", "MGNet-Cityscapes-PseudoLabelGeneration.yaml", root,
        root / "eval_tta", "MODEL.WEIGHTS", npz, timed=True)
    b = cfg.TEST.TTA_IMS_PER_BATCH
    log(f"[eval-tta] forwards of [{2 * b}, 3, H*s, W*s] for the scales s "
        f"0.5-2.0 (at 2.0: [{2 * b}, 3, {2 * cfg.INPUT.MIN_SIZE_TEST}, "
        f"{2 * cfg.INPUT.MAX_SIZE_TEST}]); averaged probabilities [{b}, H, "
        f"W, {cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES}] f32")
    log_eval_timings("eval-tta", rec, smi)
    return launches


def host_ms(fn, *args, **kwargs):
    """(fn's result, host ms of the call with the card synchronised after
    it)."""
    sync()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def same_outputs(tag, got, want):
    """Numpy dicts equal bit for bit, key for key (NaN where NaN)."""
    if list(got) != list(want):
        raise AssertionError(f"{tag}: keys {list(got)} != {list(want)}")
    for k, v in want.items():
        if got[k].dtype != v.dtype or not np.array_equal(
                got[k], v, equal_nan=v.dtype.kind == "f"):
            raise AssertionError(f"{tag}: {k} differs")


@contextlib.contextmanager
def tee_stream(name: str):
    """Copy what is written to sys.<name> within the block into a
    StringIO (yielded) and on to the stream."""
    stream, buf = getattr(sys, name), io.StringIO()

    class Tee:
        def write(self, text):
            buf.write(text)
            return stream.write(text)

        def flush(self):
            stream.flush()

    setattr(sys, name, Tee())
    try:
        yield buf
    finally:
        setattr(sys, name, stream)


def serve_predictor(smi, root: Path):
    """The Predictor on the Fine YAML with the trainer's model_final and
    the tree's camera: 3 calls, each one center_argmin launch and equal to
    the frame built on the same model and called on the same resized
    image and co-augmented camera; its host stages; then predict_batch at
    SERVE_BATCH. Returns the launches of each path and the images."""
    frames = sorted((root / "cityscapes" / "leftImg8bit" / "train" /
                     "synth").glob("*.png"))
    camera = root / "cityscapes" / "camera" / "train" / "synth" / \
        frames[0].name.replace("_leftImg8bit.png", "_camera.json")
    model_final = str(root / "out" / "model_final")
    cfg = load_config(str(CONFIG_DIR / "MGNet-Cityscapes-Fine.yaml"),
                      ["MODEL.WEIGHTS", model_final, *SERVE_OPTS])
    pred = Predictor(cfg, calibration_info=json.loads(camera.read_text()),
                     device=DEVICE)
    direct = build_fused_inference(pred.model, pred.statics,
                                   cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                                   device=DEVICE)
    images = [read_png(p) for p in frames[:SERVE_BATCH]]
    launches = {"predictor": 0}
    call_ms = []
    for i, img in enumerate(images[:3]):
        center_argmin.launches = 0
        out, ms = host_ms(pred, img)
        n = center_argmin.launches
        launches["predictor"] += n
        call_ms.append(ms)
        if n != 1:
            raise AssertionError(f"Predictor call {i}: {n} center_argmin "
                                 "launches, expected 1")
        resized, K_, height = pred.prepare(img)
        want = direct(resized[None], K_[None],
                      np.array([height], np.float32))
        same_outputs(f"Predictor call {i}",
                     out, {k: v[0].cpu().numpy() for k, v in want.items()})
    # one call's host stages: resize, copy in, frame, copy out
    (resized, K_, height), resize_ms = host_ms(pred.prepare, images[0])
    image_dev, copy_in_ms = host_ms(
        lambda: torch.from_numpy(resized[None]).to(DEVICE))
    cam = (torch.from_numpy(K_[None]).to(DEVICE),
           torch.tensor([height], device=DEVICE))
    out, frame_ms = host_ms(direct, image_dev, *cam)
    _, copy_out_ms = host_ms(lambda: {k: v[0].cpu().numpy()
                                      for k, v in out.items()})
    log(f"[serve] Predictor ({cfg.MODEL.COMPUTE_DTYPE}, model_final, the "
        f"tree's camera) on {len(call_ms)} frames of {images[0].shape[0]}x"
        f"{images[0].shape[1]}: outputs {list(out)} equal the frame called "
        f"directly, bit for bit; center_argmin 1 launch a call; ms per call "
        f"(host clock) {', '.join(f'{t:.1f}' for t in call_ms)}; one call's "
        f"stages: resize {resize_ms:.1f}, copy in {copy_in_ms:.1f}, frame "
        f"{frame_ms:.1f}, copy out {copy_out_ms:.1f} ms; {smi}")

    batch = np.stack([pred.prepare(img)[0] for img in images])
    center_argmin.launches = 0
    full, full_ms = host_ms(pred.predict_batch, batch)
    only, only_ms = host_ms(pred.predict_batch, batch, outputs=("panoptic",))
    lazy, lazy_ms = host_ms(pred.predict_batch, batch, outputs=("panoptic",),
                            materialize=False)
    launches["predict_batch"] = center_argmin.launches
    if launches["predict_batch"] != 3:
        raise AssertionError(f"predict_batch: {launches['predict_batch']} "
                             "center_argmin launches for 3 batches")
    if list(only) != ["panoptic"] or not np.array_equal(
            only["panoptic"], full["panoptic"]):
        raise AssertionError("predict_batch outputs=('panoptic',) differs "
                             "from the full dict's panoptic")
    if lazy["panoptic"].device.type != torch.device(DEVICE).type \
            or not np.array_equal(lazy["panoptic"].cpu().numpy(),
                                  full["panoptic"]):
        raise AssertionError("predict_batch materialize=False: "
                             f"{lazy['panoptic'].device}, or it differs")
    for outputs, match in ((("panoptic", "nonsense"), "not produced"),
                           (("points",), "requires camera_matrix")):
        try:
            pred.predict_batch(batch, outputs=outputs)
        except ValueError as e:
            if match not in str(e):
                raise
        else:
            raise AssertionError(f"predict_batch outputs={outputs} did not "
                                 "raise")
    log(f"[serve] predict_batch [{len(batch)}, {batch.shape[1]}, "
        f"{batch.shape[2]}, 3]: full dict {list(full)} {full_ms:.1f} ms, "
        f"('panoptic',) {only_ms:.1f} ms and equal, materialize=False "
        f"{lazy_ms:.1f} ms on {lazy['panoptic'].device} and equal (host "
        f"clock, synchronised); an unknown key and 'points' without a "
        f"camera raise ValueError; center_argmin 1 launch a batch")
    del pred, direct, full, lazy, out
    return launches, frames, camera, model_final


def serve_tools(smi, root: Path, frames, camera, model_final):
    """The pseudo-label TTA predictor on one frame, tools.demo on two
    frames, tools.generate_pseudo_labels on the tree's video-sequence
    frames; returns the launches of each path."""
    launches = {}
    npz = str(ROOT / "weights" / "imagenet_weights.npz")
    pseudo_yaml = str(CONFIG_DIR /
                      "MGNet-Cityscapes-PseudoLabelGeneration.yaml")
    pcfg = load_config(pseudo_yaml, ["MODEL.WEIGHTS", npz, *SERVE_OPTS])
    pcfg.WITH_DEPTH = False
    ppred = Predictor(pcfg, device=DEVICE)
    img = read_png(frames[0])
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    center_argmin.launches = 0
    out, ms = host_ms(ppred, img)
    launches["pseudo-label-predictor"] = center_argmin.launches
    h, w = ppred.prepare(img)[0].shape[:2]
    shapes = {k: v.shape for k, v in out.items()}
    want = {"panoptic": (h, w), "sem_seg": (h, w), "center": (h, w),
            "offset": (h, w, 2)}
    if shapes != want or launches["pseudo-label-predictor"] != 1:
        raise AssertionError(f"pseudo-label Predictor: {shapes}, "
                             f"{launches['pseudo-label-predictor']} launches")
    peak = (torch.cuda.max_memory_allocated() / 2**30 if DEVICE != "cpu"
            else float("nan"))
    log(f"[serve] pseudo-label Predictor (TTA, panoptic only, ImageNet npz): "
        f"{shapes}, 1 center_argmin launch, {ms:.1f} ms (host clock), peak "
        f"allocated {peak:.3f} GiB")
    del ppred

    out_dir = root / "demo"
    center_argmin.launches = 0
    t0 = time.perf_counter()
    demo.main(["--input", *map(str, frames[:2]), "--config-file",
               str(CONFIG_DIR / "MGNet-Cityscapes-Fine.yaml"), "--calib",
               str(camera), "--save-pcl", "--output", str(out_dir),
               "--device", DEVICE, "MODEL.WEIGHTS", model_final,
               *SERVE_OPTS])
    demo_s = time.perf_counter() - t0
    launches["demo"] = center_argmin.launches
    for f in frames[:2]:
        for kind in ("panoptic", "instances", "depth"):
            a = read_png(out_dir / f"{f.stem}_{kind}.png")
            if a.shape != (h, w, 3) or a.dtype != np.uint8:
                raise AssertionError(f"demo {kind}: {a.shape} {a.dtype}")
        points = np.load(out_dir / f"{f.stem}_points.npy")
        if points.shape != (h, w, 3):
            raise AssertionError(f"demo points: {points.shape}")
    if launches["demo"] != 2:
        raise AssertionError(f"demo: {launches['demo']} launches")
    log(f"[serve] tools.demo on 2 frames with --calib --save-pcl: "
        f"_panoptic/_instances/_depth.png decode as [{h}, {w}, 3] uint8, "
        f"_points.npy [{h}, {w}, 3]; 2 center_argmin launches; {demo_s:.1f} "
        f"s with set-up")

    DatasetCatalog.clear()
    MetadataCatalog.clear()
    labels, js = root / "pseudo", root / "pseudo.json"
    calls = {"n": 0}
    predict_batch = Predictor.predict_batch

    def counting(self, *args, **kwargs):
        calls["n"] += 1
        return predict_batch(self, *args, **kwargs)

    Predictor.predict_batch = counting
    center_argmin.launches = 0
    t0 = time.perf_counter()
    try:
        with tee_stream("stdout") as printed:
            generate_pseudo_labels.main([
                "--config-file", pseudo_yaml, "--data-root", str(root),
                "--weights", npz, "--output", str(labels), "--batch",
                str(SERVE_BATCH), "--convert-json", str(js), "--device",
                DEVICE, *SERVE_OPTS])
    finally:
        Predictor.predict_batch = predict_batch
        DatasetCatalog.clear()
        MetadataCatalog.clear()
    tool_s = time.perf_counter() - t0
    launches["pseudo-labels"] = center_argmin.launches
    written = sorted(labels.glob("*_instanceIds.png"))
    n_frames = len(frames)
    dtypes = {read_png(p).dtype for p in written}
    anns = json.loads(js.read_text())["annotations"]
    if len(written) != n_frames or dtypes != {np.dtype(np.uint16)} \
            or len(anns) != n_frames:
        raise AssertionError(f"pseudo labels: {len(written)} PNGs of "
                             f"{dtypes}, {len(anns)} annotations")
    want = math.ceil(n_frames / SERVE_BATCH)
    if not launches["pseudo-labels"] == calls["n"] == want:
        raise AssertionError(f"pseudo labels: {launches['pseudo-labels']} "
                             f"launches, {calls['n']} batches, expected "
                             f"{want}")
    steady = [ln for ln in printed.getvalue().splitlines()
              if "steady-state" in ln]
    log(f"[serve] tools.generate_pseudo_labels ({pseudo_yaml.split('/')[-1]}"
        f", TTA, --batch {SERVE_BATCH}): {len(written)} uint16 label PNGs, "
        f"{len(anns)} annotations in the JSON, {calls['n']} device batches "
        f"= {launches['pseudo-labels']} center_argmin launches, {tool_s:.1f} "
        f"s with set-up and conversion; {steady[0]}; {smi}")
    return launches


def serve_bench(smi):
    """tools.bench with --breakdown in this process, its launches counted
    (its --repeat 3 in fresh processes was measured until the validation
    phase came: PERF.md, calls T1 and T2)."""
    center_argmin.launches = 0
    with tee_stream("stderr") as err:
        rec = bench.main(["--breakdown", "--device", DEVICE, *BENCH_ARGS])
    launches = center_argmin.launches
    want = (bench.WARMUP + bench.ITERS) + (bench.WARMUP + bench.STAGE_ITERS)
    rows = [ln.split(":")[0][2:] for ln in err.getvalue().splitlines()[1:]]
    if rows != ["model_forward", "panoptic_fusion_kernel",
                "panoptic_fusion_plain", "dgc_scaling", "full_fused"] \
            or launches != want or not rec["value"] > 0:
        raise AssertionError(f"bench: rows {rows}, {launches} launches "
                             f"(expected {want}), {rec}")
    log(f"[serve] tools.bench: {rec['value']} fps ({rec['metric']}), "
        f"center_argmin {launches} launches (60 frames, 40 fused stages); "
        f"{smi}")
    return {"bench": launches}


def phase_serving(smi, root: Path):
    """The serving entry points on the trainer tree under ``root`` (with
    the trainer's model_final): returns center_argmin's launches by path,
    each counted from 0 just before it."""
    t0 = time.perf_counter()
    launches, frames, camera, model_final = serve_predictor(smi, root)
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    launches.update(serve_tools(smi, root, frames, camera, model_final))
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    launches.update(serve_bench(smi))
    log(f"[serve] phase {time.perf_counter() - t0:.1f} s; center_argmin "
        f"launches by path {launches}")
    return launches


def device_profile(fn, inputs, n: int = 5, top: int = 8):
    """(wall ms/frame, kernels' busy ms/frame, launches/frame,
    center_argmin kernel launches/frame) of ``fn(*inputs)`` over ``n``
    frames under torch.profiler; logs the ``top`` kernels by device
    time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.self_device_time_total / 1e3 / n, e.count / n, e.key)
            for e in prof.key_averages() if e.device_type == cuda]
    for dev_ms, count, key in sorted(rows, reverse=True)[:top]:
        log(f"[export]   {dev_ms:8.3f} ms/frame  x{count:5.1f}  {key[:90]}")
    return (wall_ms, sum(r[0] for r in rows), sum(r[1] for r in rows),
            sum(r[1] for r in rows if "center_argmin_kernel" in r[2]))


def frames_ms(fn, inputs, warmup: int, n: int) -> float:
    """Host-clock ms/frame of ``fn(*inputs)`` over ``n`` frames after
    ``warmup``, synchronised at the end."""
    for _ in range(warmup):
        fn(*inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*inputs)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def run_runner(smi, pkg: Path, image: torch.Tensor, want_fnv: int):
    """Build the C++ runner, run it on the package with ``image`` (and its
    own camera), check its checksum of the panoptic output against
    ``want_fnv`` and its launches; returns its center_argmin launches."""
    exe, build_s = _build.build_runner()
    raw = pkg.parent / "image.raw"
    image.cpu().numpy().tofile(raw)
    h, w = image.shape[1:3]
    res = subprocess.run(
        [str(exe), str(pkg), str(raw), str(RUNNER_ITERS), str(h), str(w)],
        capture_output=True, text=True, timeout=900)
    log(f"[export] C++ runner {exe.relative_to(ROOT)} (built in "
        f"{build_s:.1f} s): rc {res.returncode}")
    for line in res.stdout.splitlines():
        log(f"[export]   {line}")
    if res.returncode != 0:
        raise AssertionError(f"the C++ runner failed:\n{res.stderr[-4000:]}")
    fnv = int(res.stdout.split("fnv1a=")[1].split()[0], 16)
    launches = int(res.stdout.split("center_argmin launches: ")[1].split()[0])
    latency = next(ln for ln in res.stdout.splitlines()
                   if ln.startswith("latency:"))
    log(f"[export] runner {latency}; fnv1a {fnv:016x}, the Python "
        f"package's {want_fnv:016x}; {smi}")
    if fnv != want_fnv:
        raise AssertionError("the C++ runner's panoptic output differs from "
                             "the Python-loaded package's")
    if launches != 10 + RUNNER_ITERS + 1:
        raise AssertionError(f"runner: {launches} center_argmin launches")
    return launches


def export_verify(smi, out: Path, model_final: str) -> int:
    """tools.export_inference --verify on the trainer's model_final at a
    reduced size, in float32 (TF32 off, as phase 1 set it): the reloaded
    ExportedProgram equal to the live frame bit for bit, then the package
    held to it at float32's bars on every value (the bfloat16 run is the
    validation phase's child); returns center_argmin's launches in it."""
    center_argmin.launches = 0
    t0 = time.perf_counter()
    with tee_stream("stdout") as printed:
        export_inference.main([
            "--config-file", str(CONFIG_DIR / "MGNet-Cityscapes-Fine.yaml"),
            "--weights", model_final, "--output", str(out / "final.pt2"),
            "--height", str(EXPORT_VERIFY_H), "--width",
            str(EXPORT_VERIFY_W), "--verify", "--device", DEVICE,
            *SERVE_OPTS, "MODEL.COMPUTE_DTYPE", "float32"])
    launches = center_argmin.launches
    lines = printed.getvalue().splitlines()
    exact = [ln for ln in lines if ln.startswith("EXACT OK")]
    parity = [ln for ln in lines if ln.startswith("PARITY OK")]
    log(f"[export] tools.export_inference --verify on model_final (f32) at "
        f"{EXPORT_VERIFY_H}x{EXPORT_VERIFY_W}: {time.perf_counter() - t0:.1f}"
        f" s with set-up; center_argmin launches {launches}; {smi}")
    if len(exact) != 1 or len(parity) != 1 or launches != 3:
        raise AssertionError(f"export_inference --verify: {exact}, {parity}"
                             f", {launches} launches (one each in the live "
                             f"frame, the reloaded program and the package)")
    return launches


def phase_export(smi, root: Path):
    """The serving frame through torch.export and AOTInductor: export and
    compile seconds, the artifacts' bytes; the package held to the eager
    frame at export.BARS; the center_argmin kernel launched once a frame
    by the package under torch.profiler; package and eager frame times,
    launches and busy time; the C++ runner's latency and checksum; then
    export_inference --verify on the trainer's model_final. Returns
    center_argmin's launches by path."""
    t_phase = time.perf_counter()
    out = root / "export"
    cfg = slice_config("bfloat16")
    frame, statics, model = build_slice(cfg, DEVICE)
    image = request(0, H, W, DEVICE)[0].float()
    inputs = (image, torch.tensor([RUNNER_K], device=DEVICE),
              torch.tensor([RUNNER_HEIGHT], device=DEVICE))
    # random heads rarely predict road: the most common stuff class stands
    # in as the DGC ground, so that depth and points carry a real scale
    pan = frame(*inputs)["panoptic"]
    stuff = pan[(pan >= 0) & (pan % statics.label_divisor == 0)]
    road = int(torch.bincount(stuff // statics.label_divisor).argmax()) \
        * statics.label_divisor
    frame = build_fused_inference(model, statics._replace(road_class_id=road),
                                  cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                                  device=DEVICE)
    t0 = time.perf_counter()
    exported, blob = export_fused_inference(frame, (1, H, W, 3))
    export_s = time.perf_counter() - t0
    pkg, compile_s = save_exported(out / "frame.pt2", exported, blob)
    t0 = time.perf_counter()
    package = load_exported(out / "frame.pt2")
    log(f"[export] torch.export of the 1x{H}x{W} bf16 frame with a camera: "
        f"{export_s:.1f} s, ExportedProgram {len(blob)} bytes; AOTInductor "
        f"{compile_s:.1f} s, package {pkg.stat().st_size} bytes; load "
        f"{time.perf_counter() - t0:.1f} s; {smi}")

    center_argmin.launches = 0
    got = package(*inputs)
    sync()
    first = center_argmin.launches
    want = frame(*inputs)
    bars = BARS[torch.bfloat16]
    try:
        found = compare_outputs(got, want, frame.statics, *bars)
    except BarsMissed as e:
        if not bf16_open_fault("frame", e.missed):
            raise
        found = e.found
        log(f"[export] OPEN FAULT (ROADMAP Queue 3): the bf16 package misses "
            f"export.BARS against the eager frame on {e.missed}, within what "
            f"is recorded of that fault ({BF16_OPEN_FAULT['frame']})")
    log(f"[export] package against the eager frame (bf16, DGC ground "
        f"{road}): labels equal on {found['agree']} of the pixels (bar "
        f"{bars[0]}); where the classes agree, within {bars[1]} abs + "
        f"{bars[2]} rel: {found['within']} of the values (bar {bars[3]}), "
        f"max |diff| {found['max_abs']}; center_argmin launches in the first "
        f"frame {first}")
    for key in sorted(set(want) - {"sem_seg", "panoptic"}):
        g, w = got[key].float().flatten(), want[key].float().flatten()
        ok = ~torch.isnan(w)
        rel = ((g[ok] - w[ok]).abs() / w[ok].abs().clamp(min=1e-6)).cpu()
        q = torch.quantile(rel[torch.randperm(rel.numel())[:1 << 20]],
                           torch.tensor([0.5, 0.9, 0.99, 0.999]))
        log(f"[export]   {key}: |diff| / |eager| at the 50/90/99/99.9th "
            f"percentiles {[f'{v:.2e}' for v in q.tolist()]}")
    if first != 1:
        raise AssertionError(f"package: {first} center_argmin launches")

    prof = {name: device_profile(fn, inputs)
            for name, fn in (("package", package), ("eager", frame))}
    for name, (wall, busy, n, ca) in prof.items():
        log(f"[export] profiler, {name}: {n:.0f} launches/frame, kernels "
            f"busy {busy:.3f} of {wall:.3f} ms/frame wall, center_argmin "
            f"kernel launches/frame {ca:.1f}")
    if prof["package"][3] != 1.0:
        raise AssertionError(f"the package launched the center_argmin "
                             f"kernel {prof['package'][3]} times a frame")
    times = {"package": [], "eager": []}
    center_argmin.launches = 0
    for name in ("eager", "package", "package", "eager"):
        fn = package if name == "package" else frame
        times[name].append(frames_ms(fn, inputs, EXPORT_WARMUP,
                                     EXPORT_ITERS))
    timed = center_argmin.launches
    log(f"[export] steady frame (1x{H}x{W}, bf16, image on the card, "
        f"{EXPORT_ITERS} after {EXPORT_WARMUP} warmup, eager, package, "
        f"package, eager): package {times['package']} ms/frame, eager "
        f"{times['eager']}; center_argmin launches {timed} in "
        f"{4 * (EXPORT_WARMUP + EXPORT_ITERS)} frames; {smi}")
    if timed != 4 * (EXPORT_WARMUP + EXPORT_ITERS):
        raise AssertionError(f"{timed} center_argmin launches")

    launches = {"export": first, "export-profiled": int(prof["package"][3]
                                                        * 5)}
    launches["runner"] = run_runner(smi, pkg, image,
                                    fnv1a64(got["panoptic"]))
    del package, got, want, frame, model
    torch.cuda.empty_cache()
    launches["export-verify"] = export_verify(
        smi, out, str(root / "out" / "model_final"))
    log(f"[export] phase {time.perf_counter() - t_phase:.1f} s; "
        f"center_argmin launches by path {launches}")
    return launches


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def step_record(state, metrics, grads: bool):
    """A step's losses (host floats), BN running statistics and, with
    ``grads``, every parameter's gradient, all on the CPU."""
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "stats": {k: v.detach().cpu().clone() for k, v in
                     state.params.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}}
    if grads:
        out["grads"] = {n: p.grad.detach().cpu().clone() for n, p in
                        state.params.named_parameters()
                        if p.grad is not None}
    return out


def dist_equal_steps(device, rank: int, world: int):
    """DIST_STEPS f32 steps of the Fine recipe on this rank's part of the
    global batch (all of it at world 1), the last with its kernel calls
    kept and held to their plain versions: each step's record (the first
    with gradients), the parameters after and the launches."""
    cfg = train_config("float32")
    state = build_train(cfg, device)
    replicate_(state.params)  # as the Trainer does: rank 0's weights
    batch = shard_batch(train_batch(DIST_B, DIST_H, DIST_W, device), 1,
                        rank, world)
    step = make_train_step(cfg)
    records = []
    reset_counts()
    for i in range(DIST_STEPS):
        if i < DIST_STEPS - 1:
            _, m = step(state, batch)
        else:
            with last_kernel_calls() as kept:
                _, m = step(state, batch)
                torch.cuda.synchronize()
        records.append(step_record(state, m, grads=i == 0))
    launches = counts()
    check_kept_calls(f"dist-rank{rank}", cfg, kept)
    return dict(records=records, launches=launches, params={
        k: v.detach().cpu().clone()
        for k, v in state.params.state_dict().items()})


def dist_bf16_step(device, rank: int, world: int):
    """One bf16 Fine step, untimed, on this rank's part of the global batch
    of DIST_B at the recipe's 1024x1024: its kernel launches, checked
    against expected_launches(cfg), and its loss finite."""
    cfg = train_config("bfloat16")
    state = build_train(cfg, device)
    replicate_(state.params)
    batch = shard_batch(train_batch(DIST_B, TH, TW, device), 1, rank, world)
    reset_counts()
    _, m = make_train_step(cfg)(state, batch)
    torch.cuda.synchronize()
    launches, want = counts(), expected_launches(cfg)
    if launches != want or not np.isfinite(float(m["loss_total"])):
        raise AssertionError(f"rank {rank} bf16 step: launches {launches} "
                             f"(expected {want}), loss_total "
                             f"{float(m['loss_total'])}")
    return launches


def dist_rank(rank: int, world: int, port: int, backend: str,
              cards: list, out: str):
    """One spawned rank of the distribution phase on card ``cards[rank]``:
    joins the group, runs the f32 equality steps and (gloo) the bf16 step,
    and saves what they gave to ``out/rank<rank>.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                    device=DEVICE, local_rank=cards[rank],
                                    backend=backend)
    try:
        result = {"equal": dist_equal_steps(device, rank, world)}
        torch.cuda.empty_cache()
        if backend == "gloo":
            result["bf16"] = dist_bf16_step(device, rank, world)
        torch.save(result, Path(out) / f"rank{rank}.pt")
    finally:
        shutdown_distributed()


def spawn_ranks(backend: str, cards: list, out: Path):
    """DIST_RANKS ranks of dist_rank on ``cards``; their results."""
    out.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(
        dist_rank, args=(DIST_RANKS, free_port(), backend, cards, str(out)),
        nprocs=DIST_RANKS, join=True)
    log(f"[dist] {DIST_RANKS} {backend} ranks on cards {cards}: "
        f"{time.perf_counter() - t0:.1f} s with set-up")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(DIST_RANKS)]


def check_dist_equal(tag, ranks, ref):
    """Bar (iii): every loss of every step (the gradient norm as phase 5
    holds it), the first step's per-leaf gradient cosine distance and the
    BN running statistics after it against the one-rank run; the ranks'
    parameters after the steps equal bit for bit."""
    worst_loss = 0.0
    for i, want in enumerate(ref["records"]):
        for r, got in enumerate(x["records"][i] for x in ranks):
            rel = {k: abs(got["metrics"][k] - v) / max(abs(v), 1e-6)
                   for k, v in want["metrics"].items()}
            norm = rel.pop("grad_norm")
            worst = max(rel, key=rel.get)
            worst_loss = max(worst_loss, rel[worst])
            log(f"[{tag}] step {i} rank {r}: loss_total "
                f"{got['metrics']['loss_total']:.6g} (one rank "
                f"{want['metrics']['loss_total']:.6g}), worst loss rel "
                f"{rel[worst]:.2e} ({worst}), grad_norm rel {norm:.2e}")
            if rel[worst] > DIST_REL or norm > 5e-2:
                raise AssertionError(f"{tag} step {i} rank {r}: losses "
                                     "disagree with one rank")
    want = ref["records"][0]
    for r, x in enumerate(ranks):
        got = x["records"][0]
        dists = {n: cosine_distance(got["grads"][n], g)
                 for n, g in want["grads"].items()}
        if set(dists) != set(got["grads"]):
            raise AssertionError(f"{tag}: gradient names differ")
        worst = max(dists, key=dists.get)
        median = float(np.median(list(dists.values())))
        stats = {k: float((got["stats"][k] - v).abs().max()
                          / v.abs().max().clamp(min=1e-30))
                 for k, v in want["stats"].items()}
        worst_stat = max(stats, key=stats.get)
        log(f"[{tag}] rank {r} step 0: gradient cosine distance over "
            f"{len(dists)} tensors: median {median:.2e}, worst "
            f"{dists[worst]:.2e} ({worst}); BN running statistics: worst "
            f"max|diff|/max|one rank| {stats[worst_stat]:.2e} "
            f"({worst_stat})")
        if median > DIST_COS_MEDIAN or dists[worst] > DIST_COS_WORST:
            raise AssertionError(f"{tag}: gradients disagree")
        if stats[worst_stat] > DIST_REL:
            raise AssertionError(f"{tag}: running statistics disagree")
    n = 0
    for k, v in ranks[0]["params"].items():
        if not all(torch.equal(v, x["params"][k]) for x in ranks[1:]):
            raise AssertionError(f"{tag}: ranks differ in {k}")
        n += 1
    log(f"[{tag}] after {DIST_STEPS} steps the {len(ranks)} ranks hold "
        f"{n} equal tensors (parameters and BN statistics), bit for bit; "
        f"worst loss rel over the steps {worst_loss:.2e}")


def dist_cli(smi, root: Path, cards: int):
    """train_net over NCCL with --num-devices = every visible card, on the
    trainer tree under ``root``: 2 iterations (checkpoint at 2), then a
    resume for 1. Returns the kernel launches of both runs (None where
    the ranks are spawned processes)."""
    out = root / "out_nccl"
    port = free_port()
    opts = ("SOLVER.IMS_PER_BATCH", str(DIST_CLI_PER_RANK * cards))
    flags = ("--num-devices", str(cards), "--coordinator",
             f"127.0.0.1:{port}")
    backends = []
    init = train_net.initialize_distributed

    def recording(*args, **kwargs):
        device = init(*args, **kwargs)
        backends.append((torch.distributed.get_backend(),
                         torch.distributed.get_world_size()))
        return device

    train_net.initialize_distributed = recording
    reset_counts()
    t0 = time.perf_counter()
    try:
        train_net.main(trainer_argv(root, out, 2, *flags) + list(opts))
    finally:
        train_net.initialize_distributed = init
    launches = counts() if cards == 1 else None
    wall = time.perf_counter() - t0
    ckpts = sorted(os.listdir(out / "checkpoints"))
    lines = (out / "metrics.json").read_text().splitlines()
    log(f"[dist-cli] train_net --num-devices {cards}: group {backends} "
        f"(backend, ranks) in this process; {wall:.1f} s; checkpoint "
        f"files {ckpts}; metrics.json {len(lines)} lines; launches "
        f"{launches}")
    # rank 0 alone writes: one checkpoint file, no temporary left, and
    # rank 0's metric lines (the first iteration; on a card the peak
    # memory)
    if ckpts != ["2.pt"] or len(lines) != 1 + (DEVICE != "cpu"):
        raise AssertionError("train_net over NCCL: unexpected files")
    if cards == 1 and backends != [
            ("nccl" if DEVICE != "cpu" else "gloo", 1)]:
        raise AssertionError(f"train_net did not join NCCL: {backends}")

    payload = torch.load(out / "checkpoints" / "2.pt", map_location="cpu",
                         weights_only=True)
    checked = []

    class CheckedTrainer(Trainer):
        def resume_or_load(self, resume=True):
            super().resume_or_load(resume)
            checked.append(same_state(self.state, payload))

    train_net.Trainer = CheckedTrainer
    reset_counts()
    try:
        train_net.main(trainer_argv(root, out, 3, "--resume", *flags)
                       + list(opts))
    finally:
        train_net.Trainer = Trainer
    resume_launches = counts() if cards == 1 else None
    ckpts = CheckpointManager(str(out / "checkpoints")).steps()
    log(f"[dist-cli] resume for 1: restored state equal to checkpoint 2 "
        f"bit for bit ({checked} tensors; checked in this process with "
        f"one rank), checkpoints {ckpts}, launches {resume_launches}")
    if ckpts != [2, 3] or (cards == 1 and not checked):
        raise AssertionError("train_net resume over NCCL failed")
    if cards == 1:
        log(f"[dist-cli] NCCL ran with one rank on the one card ({smi}); "
            "the cross-card NCCL run and its equality wait for a machine "
            "with 2 or more cards")
    return launches, resume_launches


def phase_distribution(smi, root: Path, world1):
    """Data-parallel training on the card: (a) DIST_RANKS gloo ranks on
    the one card against one rank in this process, f32, bar (iii), every
    kernel call kept in each rank bit for bit; (b) the same ranks take one
    bf16 step at 1024x1024, its launches checked (the timing of those
    steps was measured until the validation phase came: PERF.md, calls
    U2-U4); (c) train_net over NCCL on every visible card (with 2 or more,
    (a) again over NCCL across 2 cards); (d) phase 6's world-size-1 step
    called no collective and launched within PARENT_LAUNCHES. Returns the
    kernels' launches by path."""
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    torch.cuda.empty_cache()
    ref = dist_equal_steps(torch.device(DEVICE), 0, 1)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mgnet_dist_") as tmp:
        ranks = spawn_ranks("gloo", [0] * DIST_RANKS, Path(tmp))
        check_dist_equal("dist-gloo-one-card", [r["equal"] for r in ranks],
                         ref)
        log(f"[dist-bf16] {DIST_RANKS} gloo ranks SHARING ONE CARD, one bf16 "
            f"Fine step each at global batch {DIST_B} of {TH}x{TW}: launches "
            f"{[r['bf16'] for r in ranks]}; {smi}")
        if cards >= 2:
            nccl = spawn_ranks("nccl", [0, 1], Path(tmp) / "nccl")
            check_dist_equal("dist-nccl-two-cards",
                             [r["equal"] for r in nccl], ref)
    cli, cli_resume = dist_cli(smi, root, cards)
    calls, per_step = world1
    lo, hi = PARENT_LAUNCHES
    log(f"[dist-world1] phase 6's batch-{TB} step at world size 1: "
        f"{calls} collectives in its steps; profiler launches "
        f"{per_step:.1f} per step (range {lo}-{hi})")
    if calls or not lo <= per_step <= hi:
        raise AssertionError("the world-size-1 step called a collective "
                             "or changed its launches")
    log(f"[dist] phase {time.perf_counter() - t0:.1f} s")
    paths = {"dist-one-rank": ref["launches"]}
    for r, x in enumerate(ranks):
        paths[f"dist-gloo-rank{r}"] = x["equal"]["launches"]
        paths[f"dist-bf16-rank{r}"] = x["bf16"]
    if cli is not None:
        paths.update({"dist-cli-nccl": cli, "dist-cli-nccl-resume":
                      cli_resume})
    return paths


# export_inference --verify in a child process, with the center_argmin
# launches of its three frames (live, reloaded program, package) printed
# at its end whatever its outcome; where the package misses export.BARS it
# prints the bars missed and exits with 3
VERIFY_CHILD = """\
import json
import sys
from mgnet_tpu_torch.export import BarsMissed
from mgnet_tpu_torch.ops.center_argmin import center_argmin
from mgnet_tpu_torch.tools import export_inference
try:
    export_inference.main(sys.argv[1:])
except BarsMissed as e:
    print("BARS MISSED " + json.dumps(e.missed), flush=True)
    print(f"BARS FOUND {e}", flush=True)
    sys.exit(3)
finally:
    print(f"center_argmin launches {center_argmin.launches}", flush=True)
"""


def start_verify_child(root: Path):
    """Start export_inference --verify in bfloat16 (the Fine YAML's dtype)
    on the trainer's model_final under ``root``, in a child process whose
    compile runs beside the validation phase; returns (process, its log
    path, start time)."""
    out = root / "export_bf16"
    out.mkdir(exist_ok=True)
    log_path = out / "verify.log"
    argv = ["--config-file", str(CONFIG_DIR / "MGNet-Cityscapes-Fine.yaml"),
            "--weights", str(root / "out" / "model_final"),
            "--output", str(out / "final.pt2"),
            "--height", str(EXPORT_VERIFY_H), "--width", str(EXPORT_VERIFY_W),
            "--verify", "--device", DEVICE, *SERVE_OPTS]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", VERIFY_CHILD, *argv],
                                cwd=ROOT, env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    return proc, log_path, time.perf_counter()


def finish_verify_child(child, smi) -> int:
    """Wait for the bf16 --verify child: its reloaded ExportedProgram must
    equal the live frame bit for bit, and its package must hold
    export.BARS or miss no more than the recorded open fault
    (BF16_OPEN_FAULT); anything else raises. Returns its center_argmin
    launches."""
    proc, log_path, t0 = child
    try:
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
    text = log_path.read_text()
    lines = text.splitlines()
    exact = [ln for ln in lines if ln.startswith("EXACT OK")]
    parity = [ln for ln in lines if ln.startswith("PARITY OK")]
    missed = [json.loads(ln[len("BARS MISSED "):]) for ln in lines
              if ln.startswith("BARS MISSED ")]
    launches = [int(ln.split()[-1]) for ln in lines
                if ln.startswith("center_argmin launches ")]
    log(f"[export-bf16] tools.export_inference --verify on model_final "
        f"(bf16) at {EXPORT_VERIFY_H}x{EXPORT_VERIFY_W} in a child process: "
        f"rc {rc}, {time.perf_counter() - t0:.1f} s with set-up; "
        f"center_argmin launches {launches}; {smi}")
    for ln in lines:
        if ln.startswith(("Wrote ", "EXACT OK", "PARITY OK", "BARS ")):
            log(f"[export-bf16]   {ln}")
    held = rc == 0 and len(parity) == 1 and not missed
    known = rc == 3 and not parity and len(missed) == 1 \
        and bf16_open_fault("model_final", missed[0])
    if len(exact) != 1 or len(launches) != 1 \
            or (DEVICE != "cpu" and launches != [3]) or not (held or known):
        raise AssertionError(f"export_inference --verify (bf16) failed, or "
                             f"missed more than its open fault:\n"
                             f"{text[-4000:]}")
    if known:
        log(f"[export-bf16] OPEN FAULT (ROADMAP Queue 3): the bf16 package "
            f"misses export.BARS on model_final on {missed[0]}, within what "
            f"is recorded of that fault ({BF16_OPEN_FAULT['model_final']})")
    return launches[0]


def bf16_open_fault(where: str, missed: dict) -> bool:
    """Whether the bars ``missed`` (BarsMissed.missed) are the bf16
    package's open fault at ``where`` ("frame": phase 12's seeded heads;
    "model_final": the trainer's): only bars that it is recorded to miss,
    none by more than recorded."""
    known = BF16_OPEN_FAULT[where]
    return bool(missed) and all(k in known and v is not None and v >= known[k]
                                for k, v in missed.items())


def ablation(mode: str, steps: int, width: int, smi) -> dict:
    """tools.validate_depth_overfit --mode ``mode`` on the card: it must
    PASS, through the warp and SSIM kernels on every step (2 warps, 2 SSIM
    forwards, 2 backwards a step, and the photometric loss at the analytic
    truth once more); returns their launches."""
    reset_counts()
    t0 = time.perf_counter()
    with tee_stream("stdout") as printed:
        rc = validate_depth_overfit.main([
            "--mode", mode, "--steps", str(steps), "--width", str(width),
            "--device", DEVICE])
    seconds = time.perf_counter() - t0
    launched = counts()
    want = {"warp_bilinear": 2 * steps + 2,
            "ssim_residual_fwd": 2 * steps + 2,
            "ssim_residual_bwd": 2 * steps}
    lines = printed.getvalue().splitlines()
    result = [ln for ln in lines if ln.startswith(f"{mode}: ")]
    log(f"[validate] {mode} at width {width}, {steps} steps: {result}; "
        f"{seconds:.1f} s; launches {launched}; {smi}")
    if rc != 0 or lines[-1] != f"ABLATION {mode}: PASS" or len(result) != 1 \
            or launched != want:
        raise AssertionError(f"validate_depth_overfit --mode {mode} --width "
                             f"{width}: rc {rc}, {lines[-1:]}, launches "
                             f"{launched} (expected {want})")
    return launched


def overfit(smi) -> int:
    """tools.validate_overfit on the card at OVERFIT_STEPS: the loss must
    fall and PQ, PQ_things, PQ_stuff and mIoU come out finite; they are
    printed beside the JAX package's after 1200 steps, and at 1200 steps
    the tool's gate (PQ > 80 and mIoU > 80) must pass. Returns the
    center_argmin launches of its evaluation (one per device batch of the
    six 128x256 scenes)."""
    reset_counts()
    center_argmin.launches = 0
    t0 = time.perf_counter()
    with tee_stream("stdout") as printed:
        rc = validate_overfit.main(["--steps", str(OVERFIT_STEPS),
                                    "--device", DEVICE])
    seconds = time.perf_counter() - t0
    out = printed.getvalue()
    result = json.loads(out[out.index("{\n"):out.index("OVERFIT VALID")])
    losses = [float(ln.split("'loss_total': ")[1].split(",")[0].rstrip("}"))
              for ln in out.splitlines() if "'loss_total': " in ln]
    launches = center_argmin.launches
    want = eval_batches([(128, 256)] * validate_overfit.N_SCENES,
                        get_default_config().TEST.IMS_PER_BATCH)
    log(f"[validate] validate_overfit, {OVERFIT_STEPS} steps: "
        f"{seconds:.1f} s; loss_total {losses[0]} -> {losses[-1]}; "
        + ", ".join(f"{k} {v:.4f} (JAX after 1200: {JAX_OVERFIT[k]})"
                    for k, v in result.items())
        + f"; center_argmin launches {launches}; {smi}")
    if list(result) != list(JAX_OVERFIT) \
            or not all(map(math.isfinite, result.values())) \
            or not losses[-1] < losses[0] or launches != want \
            or any(counts().values()) \
            or (OVERFIT_STEPS >= 1200 and rc != 0):
        raise AssertionError(f"validate_overfit: rc {rc}, {result}, losses "
                             f"{losses}, launches {launches} (expected "
                             f"{want}), {counts()}")
    return launches


def phase_validation(smi, root: Path):
    """The overfit validations on the card, while a child process runs the
    bf16 export_inference --verify on the trainer's model_final under
    ``root``: both depth ablations at each ABLATION_WIDTHS (each must
    PASS), then the panoptic overfit. Returns (the warp and SSIM
    launches by path, center_argmin's by path)."""
    t0 = time.perf_counter()
    child = start_verify_child(root)
    paths = {}
    try:
        for mode, steps in ABLATIONS:
            for width in ABLATION_WIDTHS:
                paths[f"{mode}-{width}"] = ablation(mode, steps, width, smi)
        argmin = {"overfit-eval": overfit(smi)}
    finally:
        argmin_bf16 = finish_verify_child(child, smi)
    argmin["export-verify-bf16"] = argmin_bf16
    log(f"[validate] phase {time.perf_counter() - t0:.1f} s")
    return paths, argmin


def phase_cpu_vs_card_eval(root: Path):
    """The f32 evaluate_dataset on the card and on the CPU, at narrow
    widths, on a tree of SMALL_VAL frames under ``root``, each held to the
    same call with the model's float64 reference on the CPU
    (models.as_float64_). The seeded model (the JAX package's init, BN at
    identity in eval mode) amplifies float32 rounding, so the two float32
    runs are held to the float64 one rather than to each other: each
    panoptic map equal to the float64 run's on >= 99.9% of pixels, the
    metric dicts with its keys, and every value within EVAL_F64_REL of it
    (relative; absolute below 1; depth/scale_ratio_median, a median of
    float16 depths, within EVAL_F64_MEDIAN_REL). The card's run launches
    center_argmin once per device batch."""
    write_cityscapes_tree(str(root), 0, 64, 128, seed=SEED,
                          val_sizes=SMALL_VAL)
    DatasetCatalog.clear()
    MetadataCatalog.clear()
    register_all_cityscapes_scene_seg(str(root))
    cfg = slice_config("float32")
    cfg.MODEL.GCM.GCM_CHANNELS = 32
    h = cfg.MODEL.SEM_SEG_HEAD
    h.ARM_CHANNELS, h.REFINE_CHANNELS = [32, 32], [32, 32]
    h.FFM_CHANNELS, h.HEAD_CHANNELS = 48, 32
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = SMALL_VAL[0]
    cfg.TEST.EVAL_INSTANCE = True
    # random heads predict no road, so DGC's ground would be empty and
    # every depth 0; without DGC the evaluator scales by the GT median
    cfg.MODEL.POST_PROCESSING.USE_DGC_SCALING = False
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(SEED))
    runs = (("f64", as_float64_(copy.deepcopy(model))), ("cpu", model),
            ("card", model))
    pans = {run: [] for run, _ in runs}
    process = PanopticEvaluator.process
    try:
        results = {}
        for run, m in runs:
            def keeping(self, pred, *args, out=pans[run], **kwargs):
                out.append(pred.copy())
                return process(self, pred, *args, **kwargs)

            PanopticEvaluator.process = keeping
            center_argmin.launches = 0
            results[run] = evaluate_dataset(
                cfg, m.to(DEVICE if run == "card" else "cpu"))
            launches = center_argmin.launches
    finally:
        PanopticEvaluator.process = process
        DatasetCatalog.clear()
        MetadataCatalog.clear()
    want = results["f64"]
    n_batches = eval_batches(SMALL_VAL, cfg.TEST.IMS_PER_BATCH)
    failed = []
    for run in ("cpu", "card"):
        got = results[run]
        agree = [float((g == w).mean()) for g, w in zip(pans[run],
                                                        pans["f64"])]
        errs = {}
        for group in want:
            if group == "eval_speed":
                continue
            if list(got[group]) != list(want[group]):
                failed.append(f"{run}: {group} keys differ")
                continue
            for k, v in want[group].items():
                errs[f"{group}/{k}"] = abs(got[group][k] - v) / max(abs(v),
                                                                    1.0)
        over = {k: e for k, e in errs.items() if e > (
            EVAL_F64_MEDIAN_REL if k == "depth/scale_ratio_median"
            else EVAL_F64_REL)}
        worst = max(errs, key=errs.get)
        log(f"[cpu-vs-card-eval] f32 evaluate_dataset on the {run} against "
            f"float64 on the CPU, {len(SMALL_VAL)} frames "
            f"{sorted(set(SMALL_VAL))}, batch {cfg.TEST.IMS_PER_BATCH}: "
            f"panoptic agreement per image {[round(a, 5) for a in agree]}; "
            f"metrics' max relative difference {errs[worst]:.3e} ({worst}); "
            f"PQ {got['panoptic_seg']['PQ']:.4f} vs "
            f"{want['panoptic_seg']['PQ']:.4f}, Abs Rel "
            f"{got['depth']['Abs Rel']:.5f} vs {want['depth']['Abs Rel']:.5f}")
        if len(agree) != len(SMALL_VAL) or min(agree) < 0.999 or over \
                or list(got) != list(want):
            failed.append(f"{run}: agreement {min(agree)}, over the bar "
                          f"{over}")
    log(f"[cpu-vs-card-eval] center_argmin launches on the card {launches} "
        f"(device batches {n_batches})")
    if failed:
        raise AssertionError(f"float32 evaluations against float64: "
                             f"{failed}")
    if DEVICE != "cpu" and launches != n_batches:
        raise AssertionError(f"card eval: {launches} center_argmin "
                             f"launches for {n_batches} device batches")


def main() -> int:
    import mgnet_tpu_torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-center-argmin", type=Path, default=None,
                    help="an earlier center_argmin.cu to time beside the "
                         "kernel on every center_argmin case")
    opts = ap.parse_args()
    if Path(mgnet_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"chip_smoke: mgnet_tpu_torch must come from {ROOT}")
    seconds = {}
    t_last = [time.perf_counter()]

    def mark(phase: str):
        """Seconds since the previous mark, kept under ``phase``."""
        now = time.perf_counter()
        seconds[phase] = round(now - t_last[0], 1)
        t_last[0] = now

    name, count, smi = phase_device()
    phase_build()
    parent = (None if opts.parent_center_argmin is None
              else load_parent_center_argmin(opts.parent_center_argmin))
    mark("device+build")
    rows = phase_kernels(smi, parent) + phase_train_kernels(smi)
    mark("kernels")
    phase_cpu_vs_card()
    rows[0]["launches"] = phase_slice(smi, parent)
    mark("frame")
    phase_cpu_vs_card_train()
    with tempfile.TemporaryDirectory(prefix="mgnet_eval_small_") as tmp:
        phase_cpu_vs_card_eval(Path(tmp))
    mark("cpu-vs-card")
    reset_counts()
    launches, world1_calls, world1_per_step = phase_train(smi)
    for row in rows[1:]:
        row["launches"] = launches[row["name"]]
    for row in rows:
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch on its path")
    mark("train")
    train_paths, frame_paths = phase_configs(smi)
    mark("configs")
    with tempfile.TemporaryDirectory(prefix="mgnet_trainer_") as tmp:
        trainer_paths = dict(zip(("trainer", "trainer-resume"),
                                 phase_trainer(smi, Path(tmp))))
        mark("trainer")
        eval_paths = phase_eval(smi, Path(tmp))
        mark("eval")
        serving_paths = phase_serving(smi, Path(tmp))
        mark("serving")
        dist_paths = phase_distribution(
            smi, Path(tmp), (world1_calls, world1_per_step))
        mark("distribution")
        export_paths = phase_export(smi, Path(tmp))
        mark("export")
        validation_paths, validation_argmin = phase_validation(
            smi, Path(tmp))
        mark("validation")
    rows[0]["launches_by_path"] = {
        "serving": rows[0]["launches"], **frame_paths,
        "trainer-eval": trainer_paths["trainer-resume"].pop("center_argmin"),
        **eval_paths, **serving_paths, **export_paths, **validation_argmin}
    for row in rows[1:]:
        row["launches_by_path"] = {"train": row["launches"], **{
            tag: n[row["name"]] for tag, n in
            {**train_paths, **trainer_paths, **dist_paths,
             **validation_paths}.items()}}
    log(f"[done] elapsed {time.perf_counter() - T_START:.1f} s; seconds by "
        f"phase {seconds}")
    log(f"[done] elapsed {time.perf_counter() - T_START:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
