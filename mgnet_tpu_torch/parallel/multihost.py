"""Process groups and host-side helpers for several processes.

Port of ``mgnet_tpu/parallel/multihost.py``: ``initialize_distributed``,
the process count and index, a barrier, and the gathers that the
evaluators and ``evaluate_dataset`` call.

``initialize_distributed`` joins this process to the default group that
carries the training step's collectives (``parallel.collectives``): NCCL
for a rank on a card, gloo on the CPU (or on the card when asked: two
gloo ranks can share one card). The host helpers below run over a second
group, always gloo, so that barriers and object gathers work whatever the
default group's backend. A default group that the caller built itself
(its own address, world size and rank) serves both. Without a group
every helper acts as the one process.

The group's ranks form the JAX package's (data, model) mesh, row-major:
rank r holds data shard ``r // model`` (``data_index``) of
``data_count`` = world / model. The model axis partitions nothing, as in
JAX (``mgnet_tpu/parallel/mesh.py``, ``batch_sharding`` is P(data)): the
``model_axis_size`` ranks of one data shard hold copies of it, which the
reductions that count (OHEM's k and n_min, ABN's n) divide out.
``initialize_distributed(model_axis=MESH.MODEL)`` sets the model axis
with the group; a caller that builds its own group, or changes the axis
within one, calls ``set_model_axis``.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["all_gather_host", "all_gather_objects", "broadcast_object",
           "data_count", "data_index", "initialize_distributed",
           "is_main_process", "model_axis_size", "process_count",
           "process_index", "set_model_axis", "shutdown_distributed",
           "synchronize"]

# the gloo group of the host helpers when the default group is not gloo
_HOST_GROUP = None
# the ranks that hold copies of one data shard (MESH.MODEL)
_MODEL_AXIS = 1


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cpu", local_rank: int = 0,
                           backend: Optional[str] = None,
                           always: bool = False,
                           model_axis: int = 1) -> torch.device:
    """Join ``num_processes`` processes in a default group whose TCP store
    listens at ``coordinator_address`` ("host:port", bound by process 0);
    this process is ``process_id``. Returns the rank's device: for a
    ``device`` of type cuda the card ``local_rank`` of this host, made the
    current card before any other CUDA work.

    ``backend`` defaults to "nccl" on a card and "gloo" on the CPU; a
    group that is not gloo gets a gloo group beside it for the host
    helpers. One process is no group at all (a no-op that returns the
    device) unless ``always``. ``model_axis`` (``MESH.MODEL``) ranks hold
    copies of each data shard (``set_model_axis``)."""
    global _HOST_GROUP
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if not always and (num_processes is None or num_processes <= 1):
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes or 1, rank=process_id or 0,
        timeout=timedelta(minutes=30))
    if backend != "gloo":
        _HOST_GROUP = dist.new_group(backend="gloo")
    set_model_axis(model_axis)
    return device


def shutdown_distributed() -> None:
    """Leave the default group (and its host group), if there is one."""
    global _HOST_GROUP, _MODEL_AXIS
    if _initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None
    _MODEL_AXIS = 1


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def set_model_axis(size: int) -> None:
    """Make ``size`` ranks hold copies of each data shard; the group's
    size must divide by it."""
    global _MODEL_AXIS
    if size < 1 or process_count() % size:
        raise ValueError(f"a model axis of {size} does not divide the "
                         f"{process_count()} ranks")
    _MODEL_AXIS = size


def model_axis_size() -> int:
    """Ranks that hold copies of one data shard; 1 without a group."""
    return _MODEL_AXIS if process_count() > 1 else 1


def data_count() -> int:
    """Data shards of the global batch: the ranks over the model axis."""
    return process_count() // model_axis_size()


def data_index() -> int:
    """This rank's data shard (row-major over (data, model))."""
    return process_index() // model_axis_size()


def is_main_process() -> bool:
    return process_index() == 0


def synchronize() -> None:
    """Barrier across the processes (a no-op for one)."""
    if process_count() > 1:
        dist.barrier(group=_HOST_GROUP)


def broadcast_object(obj: Any) -> Any:
    """Process 0's (picklable) ``obj`` on every process."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_HOST_GROUP)
    return box[0]


def all_gather_objects(obj: Any) -> list:
    """Every process's (picklable) ``obj``, ordered by process index, on
    every process."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=_HOST_GROUP)
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
