"""Host-side helpers for several processes: the process group, rank,
count, barrier and the gathers the evaluators use."""

from mgnet_tpu_torch.parallel.multihost import (
    all_gather_host,
    all_gather_objects,
    initialize_distributed,
    is_main_process,
    process_count,
    process_index,
    synchronize,
)

__all__ = ["all_gather_host", "all_gather_objects", "initialize_distributed",
           "is_main_process", "process_count", "process_index",
           "synchronize"]
