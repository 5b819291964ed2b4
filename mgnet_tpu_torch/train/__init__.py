"""The training step and its state."""

from mgnet_tpu_torch.train.state import (
    TrainParams,
    TrainState,
    create_train_state,
)
from mgnet_tpu_torch.train.step import (
    apply_uncertainty,
    compute_losses,
    make_eval_step,
    make_train_step,
    normalize_images,
    unit_image,
)

__all__ = ["TrainParams", "TrainState", "apply_uncertainty",
           "compute_losses", "create_train_state", "make_eval_step",
           "make_train_step", "normalize_images", "unit_image"]
