"""Tracing, timing and the card's roofline, for the tools.

The port's counterpart of ``mgnet_tpu/utils/profiling.py``: ``trace``
captures a ``torch.profiler`` trace into a directory (a no-op for None),
as the JAX one captures a ``jax.profiler`` trace; ``peak_hbm_gb`` reads
``torch.cuda.max_memory_allocated``; ``host_ms`` synchronises the card
around the timed calls.

The roofline uses one H100's published peak (NVIDIA's data sheet, SXM,
dense, at 700 W): 989 TFLOP/s of bf16 tensor-core math.
``count_flops`` counts a call's matrix operations (convolutions and
matrix products, forward and backward) with
``torch.utils.flop_counter.FlopCounterMode``; element-wise work and the
hand-written kernels are not in that count. ``require_device`` refuses a
card that is not there, so that a tool never falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Callable, Iterator, Optional

import torch

__all__ = ["PEAK_BF16_FLOPS", "count_flops", "device_line", "host_ms",
           "peak_hbm_gb", "require_device", "sync", "trace"]

PEAK_BF16_FLOPS = 989e12


def require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a visible card
    raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA card is visible "
                           "(pass --device cpu for a run on the host)")
    return device


def device_line(device) -> str:
    """What ran the numbers: on a card, its name and nvidia-smi's name and
    power limit; else the host, whose times are no card's."""
    device = torch.device(device)
    if device.type != "cuda":
        return (f"device: {device} (the host's CPU: these times are not "
                "a card's)")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except OSError:
        smi = []
    return (f"device: {torch.cuda.get_device_name(device)}; nvidia-smi: "
            f"{smi[0] if smi else 'not available'}")


def sync(device=None) -> None:
    """Wait for the card (nothing on the CPU)."""
    if device is None or torch.device(device).type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block (CPU and, when
    there is a card, CUDA activity) into ``logdir``: ``trace.json`` for
    chrome://tracing or Perfetto and ``kernels.txt``, the device (or CPU)
    time by operator. A no-op when ``logdir`` is None or empty."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    key = ("self_cuda_time_total" if len(acts) > 1
           else "self_cpu_time_total")
    with open(os.path.join(logdir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=key, row_limit=40))


def peak_hbm_gb(device="cuda") -> Optional[float]:
    """The peak memory allocated on ``device`` since the process started
    (or the last ``torch.cuda.reset_peak_memory_stats``), in GiB; None for
    a device that is not a CUDA card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def host_ms(fn: Callable, iters: int, warmup: int = 2, device=None) -> float:
    """Milliseconds per call of ``fn()``: the host clock around ``iters``
    calls after ``warmup``, the card synchronised before and after (the
    calls queue back to back, as a loop of them would)."""
    for _ in range(warmup):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


def count_flops(fn: Callable) -> int:
    """The matrix operations (FLOPs, an FMA counted as two) of one call of
    ``fn()``, by ``FlopCounterMode``: convolutions and matrix products,
    with their backward when ``fn`` runs one."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())
