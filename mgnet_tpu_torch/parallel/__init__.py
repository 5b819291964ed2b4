"""Several processes: the process groups, the data-parallel layout, the
training step's collectives, and the host-side barrier and gathers that
the evaluators use."""

from mgnet_tpu_torch.parallel.collectives import (
    all_mean,
    all_sum,
    average_gradients,
    reduce_,
)
from mgnet_tpu_torch.parallel.mesh import (
    data_parallel_size,
    local_positions,
    replicate_,
    shard_batch,
)
from mgnet_tpu_torch.parallel.multihost import (
    all_gather_host,
    all_gather_objects,
    broadcast_object,
    initialize_distributed,
    is_main_process,
    process_count,
    process_index,
    shutdown_distributed,
    synchronize,
)

__all__ = ["all_gather_host", "all_gather_objects", "all_mean", "all_sum",
           "average_gradients", "broadcast_object", "data_parallel_size",
           "initialize_distributed", "is_main_process", "local_positions",
           "process_count", "process_index", "reduce_", "replicate_",
           "shard_batch", "shutdown_distributed", "synchronize"]
