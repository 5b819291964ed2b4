"""Checkpoints of the whole training state, and params-only snapshots.

The port's counterpart of ``mgnet_tpu/utils/checkpoint.py`` (orbax, which
the card's machine lacks; the two formats do not interoperate, and JAX
weights enter the port as arrays through ``utils.weights.load_jax_params``).

``CheckpointManager`` keeps step checkpoints ``<dir>/<step>.pt``, each a
``torch.save`` of the whole ``train.state.TrainState``: the parameters and
BN running statistics (``params.state_dict()``), the optimizer's moments
and update count, and the step. ``restore`` reads the latest (or a given)
step with ``torch.load(weights_only=True)`` into an existing state, in
place. The ``max_to_keep`` newest are kept. ``save_params`` /
``load_params`` write and read the params-only snapshot (the directory
``model_final`` that training ends with: ``<dir>/params.pt``).

Every file is written to a temporary name beside it and moved into place
with ``os.replace``, so a reader never sees half a file. Under several
processes only process 0 writes (``save``, ``save_params``); every
process reads, and the caller puts a barrier between the two. Saves are
synchronous, so orbax's ``wait`` and ``close`` have no counterpart.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from mgnet_tpu_torch.parallel.multihost import is_main_process

__all__ = ["CheckpointManager", "load_params", "save_params"]


def _save(payload, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def steps(self):
        """The saved steps, oldest first."""
        return sorted(int(n[:-3]) for n in os.listdir(self.directory)
                      if n.endswith(".pt") and n[:-3].isdigit())

    def save(self, step: int, state) -> None:
        """Write step ``step`` (process 0 only) and drop the oldest beyond
        ``max_to_keep``."""
        if not is_main_process():
            return
        _save({"params": state.params.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "step": int(state.step)}, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state, step: Optional[int] = None) -> Tuple[object, bool]:
        """Load step ``step`` (default: the latest) into ``state`` in place;
        returns (state, whether a checkpoint was restored)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return state, False
        payload = _load(self._path(step))
        state.params.load_state_dict(payload["params"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state, True


def save_params(path: str, module: torch.nn.Module) -> None:
    """Write ``module``'s parameters and buffers (for a ``TrainParams``:
    the model, its BN statistics and ``log_vars``) to ``path/params.pt``
    (process 0 only)."""
    if not is_main_process():
        return
    os.makedirs(path, exist_ok=True)
    _save(module.state_dict(), os.path.join(path, "params.pt"))


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict that ``save_params`` wrote to ``path``, on the CPU."""
    return _load(os.path.join(path, "params.pt"))
