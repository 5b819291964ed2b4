"""Optimizer of the training step: clip, weight decay, Adam, per-group LR
and the warmup-poly schedule.

Port of ``mgnet_tpu/solver/build.py::build_optimizer`` for ADAM, without
optax. The update of every step follows the JAX package's optax chain in
its order:

1. global-norm clip over ALL trainable parameters (``log_vars``
   included): g * min(1, max_norm / ||g||), optax's
   ``clip_by_global_norm`` (not ``torch.nn.utils.clip_grad_norm_``, which
   divides by ||g|| + 1e-6);
2. L2 weight decay g += wd * p through the weight / bias / norm masks
   (``log_vars`` never decays);
3. Adam moments with betas (0.9, 0.999), bias correction, and eps 1e-8
   outside the square root;
4. the per-parameter LR multiplier: ``HEAD_LR_FACTOR`` for parameters
   under ``sem_seg_head``, ``ins_embed_head`` or ``depth_head``, 1 else;
5. x -lr, with the warmup-poly LR evaluated at the step count BEFORE the
   increment (step 0 runs at WARMUP_FACTOR * BASE_LR).

The moments and the update use ``torch._foreach_*`` ops (one launch per
op for all parameters on the card).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import torch

__all__ = ["HEAD_MODULES", "Optimizer", "build_optimizer",
           "lr_multiplier", "warmup_poly_schedule", "weight_decay_group"]

HEAD_MODULES = ("sem_seg_head", "ins_embed_head", "depth_head")


def warmup_poly_schedule(base_lr: float, max_iter: int, power: float = 0.9,
                         warmup_factor: float = 0.1,
                         warmup_iters: int = 1000,
                         constant_ending: float = 0.0) -> Callable:
    """WarmupPolyLR: linear warmup from ``warmup_factor`` times a poly
    decay (mgnet_tpu/solver/build.py:33-57)."""

    def schedule(step: int) -> float:
        step = float(step)
        alpha = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
        warmup = warmup_factor * (1.0 - alpha) + alpha
        poly = max(1.0 - step / max_iter, 0.0) ** power
        if constant_ending > 0 and warmup == 1.0:
            poly = max(poly, constant_ending)
        return base_lr * warmup * poly

    return schedule


def lr_multiplier(name: str, head_lr_factor: float) -> float:
    """Head modules train at ``head_lr_factor`` x the base LR."""
    return head_lr_factor if any(h in name for h in HEAD_MODULES) else 1.0


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
    parameters. ``step()`` reads each parameter's ``.grad`` (a parameter
    without one counts as a zero gradient, as in JAX)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 schedule: Callable, *, clip_norm=None,
                 decay: Dict[str, float] = None, head_lr_factor=1.0,
                 b1=0.9, b2=0.999, eps=1e-8):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        self.names: List[str] = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        self.schedule = schedule
        self.clip_norm = clip_norm
        decay = decay or {}
        self.decay = [decay.get(weight_decay_group(n), 0.0)
                      for n in self.names]
        self.mults = [lr_multiplier(n, head_lr_factor) for n in self.names]
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

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
        for i, wd in enumerate(self.decay):
            if wd > 0:
                grads[i] = grads[i] + wd * self.params[i]
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
        updates = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(updates, self.mults)
        torch._foreach_mul_(updates, -self.schedule(self.count))
        torch._foreach_add_(self.params, updates)
        self.count = count
        return norm


def build_optimizer(cfg, named_params) -> Optimizer:
    """The SOLVER section's optimizer over ``named_params`` (ADAM only; SGD
    and ADAMW come with the trainer)."""
    s = cfg.SOLVER
    if s.OPTIMIZER.upper() != "ADAM":
        raise NotImplementedError(
            f"optimizer {s.OPTIMIZER}: the port has ADAM only so far "
            f"(ROADMAP)")
    if s.LR_SCHEDULER_NAME != "WarmupPolyLR":
        raise NotImplementedError(
            f"LR scheduler {s.LR_SCHEDULER_NAME}: the port has WarmupPolyLR "
            f"only so far (ROADMAP)")
    clip = None
    if s.CLIP_GRADIENTS.ENABLED:
        if s.CLIP_GRADIENTS.CLIP_TYPE != "full_model":
            raise ValueError("only full_model clipping is supported")
        clip = s.CLIP_GRADIENTS.CLIP_VALUE
    schedule = warmup_poly_schedule(
        s.BASE_LR, s.MAX_ITER, s.POLY_LR_POWER, s.WARMUP_FACTOR,
        s.WARMUP_ITERS, s.POLY_LR_CONSTANT_ENDING)
    decay = {"weight": s.WEIGHT_DECAY, "bias": s.WEIGHT_DECAY_BIAS,
             "norm": s.WEIGHT_DECAY_NORM}
    return Optimizer(named_params, schedule, clip_norm=clip, decay=decay,
                     head_lr_factor=s.HEAD_LR_FACTOR)
