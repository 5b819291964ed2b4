"""The training step's optimizer (clip, weight decay, Adam, LR groups and
schedule)."""

from mgnet_tpu_torch.solver.build import (
    Optimizer,
    build_optimizer,
    warmup_poly_schedule,
)

__all__ = ["Optimizer", "build_optimizer", "warmup_poly_schedule"]
