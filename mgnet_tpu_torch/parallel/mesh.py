"""The data-parallel layout: one rank per card, the batch split over the
ranks.

Port of ``mgnet_tpu/parallel/mesh.py``. The JAX package's ``(data,
model)`` mesh becomes the default process group: ``data_parallel_size``
is its ``data`` axis, ``shard_batch`` this rank's slice of a global batch
(the counterpart of placing a batch sharded on ``data``), and
``replicate_`` the broadcast of rank 0's parameters and buffers
(``replicate_to_mesh``). The ``model`` axis partitions nothing, as in
the JAX package: ``MESH.MODEL`` ranks hold copies of each data shard
(``multihost.model_axis_size``), rank r the shard ``r // MODEL``.

Micro-batches: the JAX step splits the GLOBAL batch into ``k`` contiguous
micro-batches (``SOLVER.GRAD_ACCUM_STEPS``). A rank holds, of each global
micro-batch, its contiguous 1/world share, in micro-batch order, so that
the step's local split of its batch into ``k`` gives each rank its share
of the same global micro-batch. With ``k = 1`` a rank's slice is its
contiguous ``batch / world`` samples, as the JAX loader's.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist
from torch import nn

from mgnet_tpu_torch.parallel.multihost import (
    data_count,
    data_index,
    model_axis_size,
    process_count,
)

__all__ = ["data_parallel_size", "local_positions", "replicate_",
           "shard_batch"]


def data_parallel_size(cfg) -> int:
    """The data axis: ``MESH.DATA`` (-1 = the group's ranks over
    ``MESH.MODEL``), which times ``MESH.MODEL`` must be the group's size;
    ``MESH.MODEL`` must be the group's model axis
    (``initialize_distributed``'s ``model_axis``)."""
    world = process_count()
    model = int(cfg.MESH.MODEL)
    data = int(cfg.MESH.DATA)
    if model < 1 or world % model or data not in (-1, world // model):
        raise ValueError(f"MESH.DATA={data} x MESH.MODEL={model} but the "
                         f"process group has {world} ranks; the product "
                         "must be the world size (DATA -1: world / MODEL)")
    if world > 1 and model != model_axis_size():
        raise ValueError(f"MESH.MODEL={model} but the group's model axis is "
                         f"{model_axis_size()}: pass model_axis to "
                         "initialize_distributed (or set_model_axis)")
    return world // model


def local_positions(batch: int, rank: int, world: int,
                    micro_batches: int = 1) -> List[int]:
    """Positions in a global batch of ``batch`` samples that rank ``rank``
    of ``world`` holds: its share of each of the ``micro_batches``
    contiguous micro-batches, in order."""
    if batch % (world * micro_batches):
        raise ValueError(f"global batch {batch} does not divide over "
                         f"{world} ranks x {micro_batches} micro-batches")
    m = batch // micro_batches
    share = m // world
    return [i * m + rank * share + j for i in range(micro_batches)
            for j in range(share)]


def shard_batch(batch: Dict, micro_batches: int = 1, rank=None,
                world=None) -> Dict:
    """Data shard ``rank`` of ``world`` of a global ``batch`` (every array
    or tensor's dim 0, see ``local_positions``; by default this rank's
    shard, ``multihost.data_index`` of ``data_count``); other values pass
    through."""
    rank = data_index() if rank is None else rank
    world = data_count() if world is None else world
    if world == 1:
        return batch
    out = {}
    pos = None
    for k, v in batch.items():
        if hasattr(v, "shape") and len(v.shape):
            if pos is None:
                pos = local_positions(v.shape[0], rank, world, micro_batches)
            v = v[pos] if micro_batches > 1 else v[pos[0]:pos[-1] + 1]
        out[k] = v
    return out


@torch.no_grad()
def replicate_(module: nn.Module) -> nn.Module:
    """Every parameter and buffer of ``module`` set to rank 0's, in place;
    nothing at world 1."""
    if process_count() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module
