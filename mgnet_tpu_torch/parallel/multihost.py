"""Host-side helpers for several processes.

Port of ``mgnet_tpu/parallel/multihost.py``: ``initialize_distributed``,
the process count and index, a barrier, and the two gathers that the
evaluators and ``evaluate_dataset`` call. They run over
``torch.distributed`` when its default group is initialized (by
``initialize_distributed``, or by the caller with its own address, world
size and rank), and as the one process otherwise.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch.distributed as dist

__all__ = ["all_gather_host", "all_gather_objects", "initialize_distributed",
           "is_main_process", "process_count", "process_index",
           "synchronize"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Join ``num_processes`` processes (a no-op for one) in a gloo group
    whose TCP store listens at ``coordinator_address`` ("host:port", bound
    by process 0); this process is ``process_id``. Gloo carries the host
    helpers below: barriers and object gathers."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def synchronize() -> None:
    """Barrier across the processes (a no-op for one)."""
    if process_count() > 1:
        dist.barrier()


def all_gather_objects(obj: Any) -> list:
    """Every process's (picklable) ``obj``, ordered by process index, on
    every process."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def all_gather_host(data: Any) -> Any:
    """Gather a pytree (dicts, lists, tuples) of numpy arrays: each leaf
    becomes the stack of every process's leaf, [processes, ...], as
    ``process_allgather`` gives; one process gets ``data`` back."""
    if process_count() == 1:
        return data
    trees = all_gather_objects(data)

    def stack(*leaves):
        first = leaves[0]
        if isinstance(first, dict):
            return {k: stack(*(t[k] for t in leaves)) for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(stack(*xs) for xs in zip(*leaves))
        return np.stack([np.asarray(x) for x in leaves])

    return stack(*trees)
