"""The training step's optimizer (clip, weight decay, Adam / AdamW / SGD,
LR groups, the backbone freeze mask and the schedules)."""

from mgnet_tpu_torch.solver.build import (
    Optimizer,
    build_optimizer,
    warmup_cosine_schedule,
    warmup_poly_schedule,
)

__all__ = ["Optimizer", "build_optimizer", "warmup_cosine_schedule",
           "warmup_poly_schedule"]
