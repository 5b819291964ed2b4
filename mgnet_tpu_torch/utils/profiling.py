"""Peak device memory and a steady-state timer.

The port's counterpart of ``mgnet_tpu/utils/profiling.py``: ``peak_hbm_gb``
reads ``torch.cuda.max_memory_allocated``, and ``steady_state_timer``
synchronises the card around the timed calls.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

__all__ = ["peak_hbm_gb", "steady_state_timer"]


def peak_hbm_gb(device="cuda") -> Optional[float]:
    """The peak memory allocated on ``device`` since the process started
    (or the last ``torch.cuda.reset_peak_memory_stats``), in GiB; None for
    a device that is not a CUDA card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def steady_state_timer(fn: Callable, args=(), warmup: int = 10,
                       iters: int = 50) -> float:
    """Seconds per call after warmup, with the card synchronised after each
    call (on the CPU, the host clock alone)."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
        _sync()
    return (time.perf_counter() - t0) / iters
