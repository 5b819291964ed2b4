"""Optimizer of the training step: clip, weight decay, Adam / AdamW / SGD,
per-group LR, the backbone freeze mask and the warmup schedules.

Port of ``mgnet_tpu/solver/build.py::build_optimizer``, without optax. The
update of every step follows the JAX package's optax chain in its order:

1. global-norm clip over ALL trainable parameters (``log_vars``
   included): g * min(1, max_norm / ||g||), optax's
   ``clip_by_global_norm`` (not ``torch.nn.utils.clip_grad_norm_``, which
   divides by ||g|| + 1e-6);
2. for ADAM and SGD, L2 weight decay g += wd * p through the weight /
   bias / norm masks (``log_vars`` never decays);
3. the moments: Adam's (``scale_by_adam``: betas (0.9, 0.999), bias
   correction, eps 1e-8 outside the square root), or SGD's momentum trace
   t = g + MOMENTUM * t (``optax.trace``, not Nesterov), which is the
   update;
4. for ADAMW, the decay u += wd * p after the moments: neither clipped
   nor seen by them;
5. the per-parameter LR multiplier: ``HEAD_LR_FACTOR`` for parameters
   under ``sem_seg_head``, ``ins_embed_head`` or ``depth_head``, 1 else;
6. the ``MODEL.BACKBONE.FREEZE_AT`` mask: x 0 for the stem (FREEZE_AT
   >= 1) and the ``res{k}_`` blocks (FREEZE_AT >= k) under ``backbone``,
   matched on the JAX flat key, so that the PoseCNN encoder never
   freezes. Frozen leaves keep their moments and BN running statistics
   moving, as in JAX; their update is zero;
7. x -lr, with the schedule (WarmupPolyLR or WarmupCosineLR, which does
   not clamp past MAX_ITER) evaluated at the step count BEFORE the
   increment (step 0 runs at WARMUP_FACTOR * BASE_LR).

The learning rate is a Python float. The moments and the update use
``torch._foreach_*`` ops (one launch per op for all parameters on the
card).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Tuple

import torch

from mgnet_tpu_torch.utils.weights import jax_key

__all__ = ["HEAD_MODULES", "Optimizer", "build_optimizer", "frozen",
           "lr_multiplier", "warmup_cosine_schedule", "warmup_poly_schedule",
           "weight_decay_group"]

HEAD_MODULES = ("sem_seg_head", "ins_embed_head", "depth_head")
OPTIMIZERS = ("ADAM", "ADAMW", "SGD")


def _warmup(step: float, warmup_factor: float, warmup_iters: int) -> float:
    alpha = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
    return warmup_factor * (1.0 - alpha) + alpha


def warmup_poly_schedule(base_lr: float, max_iter: int, power: float = 0.9,
                         warmup_factor: float = 0.1,
                         warmup_iters: int = 1000,
                         constant_ending: float = 0.0) -> Callable:
    """WarmupPolyLR: linear warmup from ``warmup_factor`` times a poly
    decay (mgnet_tpu/solver/build.py:33-57)."""

    def schedule(step: int) -> float:
        step = float(step)
        warmup = _warmup(step, warmup_factor, warmup_iters)
        poly = max(1.0 - step / max_iter, 0.0) ** power
        if constant_ending > 0 and warmup == 1.0:
            poly = max(poly, constant_ending)
        return base_lr * warmup * poly

    return schedule


def warmup_cosine_schedule(base_lr: float, max_iter: int,
                           warmup_factor: float = 0.1,
                           warmup_iters: int = 1000) -> Callable:
    """WarmupCosineLR: linear warmup times 0.5 (1 + cos(pi step /
    max_iter)), unclamped past ``max_iter`` (mgnet_tpu/solver/build.py:
    116-128)."""

    def schedule(step: int) -> float:
        step = float(step)
        cos = 0.5 * (1.0 + math.cos(math.pi * step / max_iter))
        return base_lr * _warmup(step, warmup_factor, warmup_iters) * cos

    return schedule


def lr_multiplier(name: str, head_lr_factor: float) -> float:
    """Head modules train at ``head_lr_factor`` x the base LR."""
    return head_lr_factor if any(h in name for h in HEAD_MODULES) else 1.0


def frozen(key: str, freeze_at: int) -> bool:
    """Whether FREEZE_AT freezes the leaf at JAX flat key ``key``
    (``freeze_mask_tree``, mgnet_tpu/solver/build.py:131-148)."""
    if "backbone" not in key:
        return False
    if "stem" in key and freeze_at >= 1:
        return True
    return any(f"res{stage}_" in key and freeze_at >= stage
               for stage in range(2, 6))


def weight_decay_group(name: str) -> str:
    """'weight', 'bias', 'norm' or 'none' (mgnet_tpu/solver/build.py:83-110,
    on the port's parameter names: ABN parameters live under ``abn``)."""
    if "log_vars" in name:
        return "none"
    if "abn" in name:
        return "norm"
    if name.endswith("bias"):
        return "bias"
    if name.endswith("weight"):
        return "weight"
    return "none"


class Optimizer:
    """The optax chain of the JAX package as one stateful object over named
    parameters (their names map to JAX flat keys through
    ``utils.weights.jax_key``). ``step()`` reads each parameter's ``.grad``
    (a parameter without one counts as a zero gradient, as in JAX)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 schedule: Callable, *, kind: str = "ADAM", clip_norm=None,
                 decay: Dict[str, float] = None, head_lr_factor=1.0,
                 freeze_at: int = 0, momentum: float = 0.9,
                 b1=0.9, b2=0.999, eps=1e-8):
        if kind not in OPTIMIZERS:
            raise ValueError(f"Unknown optimizer: {kind}")
        named = [(n, p) for n, p in named_params if p.requires_grad]
        self.kind = kind
        self.names: List[str] = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        self.schedule = schedule
        self.clip_norm = clip_norm
        decay = decay or {}
        self.decay = [decay.get(weight_decay_group(n), 0.0)
                      for n in self.names]
        self.frozen = [frozen(jax_key(n), freeze_at) for n in self.names]
        self.mults = [0.0 if f else lr_multiplier(n, head_lr_factor)
                      for n, f in zip(self.names, self.frozen)]
        self.momentum = momentum
        self.b1, self.b2, self.eps = b1, b2, eps
        # Adam's first moment, or SGD's momentum trace
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = ([torch.zeros_like(p) for p in self.params]
                   if kind != "SGD" else [])
        self.count = 0

    def state_dict(self) -> Dict:
        """The moments and the update count, with the parameter names they
        belong to."""
        return {"names": list(self.names), "mu": list(self.mu),
                "nu": list(self.nu), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Copy a ``state_dict`` into the moments in place (each keeps its
        device); raises unless the parameter names and shapes agree."""
        if list(state["names"]) != self.names or len(state["mu"]) != len(
                self.mu) or len(state["nu"]) != len(self.nu):
            raise ValueError("optimizer state is for other parameters")
        for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            if dst.shape != src.shape:
                raise ValueError(f"optimizer moment of shape "
                                 f"{tuple(src.shape)} for {tuple(dst.shape)}")
            dst.copy_(src)
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _decayed(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        return [v + wd * p if wd > 0 else v
                for v, p, wd in zip(values, self.params, self.decay)]

    def _adam(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        count = self.count + 1
        mu_hat = torch._foreach_div(self.mu, 1.0 - b1 ** count)
        nu_hat = torch._foreach_div(self.nu, 1.0 - b2 ** count)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        return list(torch._foreach_div(mu_hat, denom))

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update; returns the global gradient norm before the
        clip (a tensor on the parameters' device)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / norm, max=1.0)
            grads = list(torch._foreach_mul(grads, scale))
        if self.kind == "SGD":
            grads = self._decayed(grads)
            torch._foreach_mul_(self.mu, self.momentum)
            torch._foreach_add_(self.mu, grads)
            updates = [t.clone() for t in self.mu]
        elif self.kind == "ADAM":
            updates = self._adam(self._decayed(grads))
        else:
            updates = self._decayed(self._adam(grads))
        torch._foreach_mul_(updates, self.mults)
        torch._foreach_mul_(updates, -self.schedule(self.count))
        torch._foreach_add_(self.params, updates)
        self.count += 1
        return norm


def build_optimizer(cfg, named_params) -> Optimizer:
    """The SOLVER section's optimizer over ``named_params``, with
    MODEL.BACKBONE.FREEZE_AT's mask."""
    s = cfg.SOLVER
    if s.LR_SCHEDULER_NAME == "WarmupPolyLR":
        schedule = warmup_poly_schedule(
            s.BASE_LR, s.MAX_ITER, s.POLY_LR_POWER, s.WARMUP_FACTOR,
            s.WARMUP_ITERS, s.POLY_LR_CONSTANT_ENDING)
    elif s.LR_SCHEDULER_NAME == "WarmupCosineLR":
        schedule = warmup_cosine_schedule(
            s.BASE_LR, s.MAX_ITER, s.WARMUP_FACTOR, s.WARMUP_ITERS)
    else:
        raise ValueError(f"Unknown LR scheduler: {s.LR_SCHEDULER_NAME}")
    clip = None
    if s.CLIP_GRADIENTS.ENABLED:
        if s.CLIP_GRADIENTS.CLIP_TYPE != "full_model":
            raise ValueError("only full_model clipping is supported")
        clip = s.CLIP_GRADIENTS.CLIP_VALUE
    decay = {"weight": s.WEIGHT_DECAY, "bias": s.WEIGHT_DECAY_BIAS,
             "norm": s.WEIGHT_DECAY_NORM}
    return Optimizer(named_params, schedule, kind=s.OPTIMIZER.upper(),
                     clip_norm=clip, decay=decay,
                     head_lr_factor=s.HEAD_LR_FACTOR,
                     freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT or 0,
                     momentum=s.MOMENTUM)
