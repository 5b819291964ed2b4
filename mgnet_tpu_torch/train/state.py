"""Train state: the parameters (model and uncertainty weights), the
optimizer and the step count.

Port of ``mgnet_tpu/train/state.py``. The JAX state's params tree
``{"model": ..., "log_vars": [5]}`` is one module here, ``TrainParams``,
whose names map onto its flat keys (``model.backbone...`` <->
``model/backbone/...``, ``log_vars`` <-> ``log_vars``; utils/weights.py).
The BN running statistics are the model's buffers.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["TrainParams", "TrainState", "create_train_state"]


class TrainParams(nn.Module):
    """The model and, with uncertainty weighting, the 5 homoscedastic
    task-uncertainty parameters ``log_vars`` (zeros at the start)."""

    def __init__(self, model: nn.Module, with_uncertainty: bool = True):
        super().__init__()
        self.model = model
        if with_uncertainty:
            device = next(model.parameters()).device
            self.log_vars = nn.Parameter(torch.zeros(5, device=device))
        else:
            self.log_vars = None


class TrainState:
    """Mutable training state; the train step updates it in place."""

    def __init__(self, params: TrainParams, optimizer):
        self.params = params
        self.optimizer = optimizer
        self.step = 0


def create_train_state(cfg, model: nn.Module) -> TrainState:
    """Wrap a model built ``for_training`` with its uncertainty weights and
    the SOLVER's optimizer over all of them."""
    from mgnet_tpu_torch.solver import build_optimizer

    params = TrainParams(model, cfg.WITH_UNCERTAINTY)
    return TrainState(params,
                      build_optimizer(cfg, params.named_parameters()))
