"""The port's optimizer against ``mgnet_tpu.solver.build_optimizer``'s
optax chain, fed the same gradients: ADAM, ADAMW and SGD, each schedule,
FREEZE_AT 0 and 2, weight decay off and on.

The parameter tree's names hit the stem and res2/res3 blocks of the
backbone (frozen at FREEZE_AT 2 up to res2), the same names under the
PoseCNN encoder (never frozen), a head (LR x HEAD_LR_FACTOR), ABN leaves,
biases and ``log_vars``. The optax chain runs eagerly (no compile).
Parameters agree to 1e-6, the bar of test_torch_train_step.py's
``test_optimizer_matches_the_optax_chain``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgnet_tpu.config import get_default_config as j_default_config
from mgnet_tpu.solver import build_optimizer as j_build_optimizer
from mgnet_tpu.utils.weights import flatten_params
from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.solver import build_optimizer
from mgnet_tpu_torch.solver.build import warmup_cosine_schedule
from mgnet_tpu_torch.utils.weights import to_jax_arrays, torch_key

SHAPES = {
    "model/backbone/stem/conv1/conv/kernel": (3, 3, 2, 4),
    "model/backbone/stem/conv1/abn/BatchNorm_0/scale": (4,),
    "model/backbone/stem/conv1/abn/BatchNorm_0/bias": (4,),
    "model/backbone/res2_block0/conv1/conv/kernel": (3, 3, 4, 4),
    "model/backbone/res2_block1/conv2/abn/BatchNorm_0/scale": (4,),
    "model/backbone/res3_block0/conv1/conv/kernel": (3, 3, 4, 6),
    "model/backbone/res3_block0/shortcut/abn/BatchNorm_0/bias": (6,),
    "model/pose_net/encoder/stem/conv1/conv/kernel": (3, 3, 6, 4),
    "model/pose_net/encoder/res2_block0/conv1/abn/BatchNorm_0/scale": (4,),
    "model/pose_net/conv1/kernel": (1, 1, 4, 6),
    "model/pose_net/conv1/bias": (6,),
    "model/sem_seg_head/head/predictor/kernel": (1, 1, 4, 3),
    "model/sem_seg_head/head/predictor/bias": (3,),
    "model/depth_head/head0/head/abn/BatchNorm_0/scale": (4,),
    "log_vars": (5,),
}
# global gradient norms ~0.4, ~4, ~0.4 against the clip at 1.0. Three
# steps, as test_torch_train_step.py's chain test: optax evaluates Adam's
# bias correction 1 - b2^t in f32 (1 - f32(0.999) is 1.3e-5 off 1e-3),
# the port in f64, so that the parameters drift apart a little each step
GRAD_SCALES = (0.1, 1.0, 0.1)
SOLVER = dict(BASE_LR=1e-2, WARMUP_ITERS=2, HEAD_LR_FACTOR=10.0,
              MOMENTUM=0.9)
# cosine: step 2 runs past MAX_ITER, where it rises again (no clamp)
MAX_ITER = {"WarmupPolyLR": 10, "WarmupCosineLR": 1}
DECAY = dict(WEIGHT_DECAY=1e-4, WEIGHT_DECAY_BIAS=1e-4,
             WEIGHT_DECAY_NORM=1e-4)
CLIP = 1.0


def _configure(cfg, opt, sched, freeze_at, wd):
    cfg.SOLVER.OPTIMIZER = opt
    cfg.SOLVER.LR_SCHEDULER_NAME = sched
    cfg.SOLVER.MAX_ITER = MAX_ITER[sched]
    for k, v in SOLVER.items():
        setattr(cfg.SOLVER, k, v)
    for k, v in DECAY.items():
        setattr(cfg.SOLVER, k, v if wd else 0.0)
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = CLIP
    cfg.MODEL.BACKBONE.FREEZE_AT = freeze_at
    return cfg


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


def _torch_layout(a):
    return torch.from_numpy(
        a.transpose(3, 2, 0, 1).copy() if a.ndim == 4 else a.copy())


def _optax_run(cfg, flat, grads_seq):
    params = _nest(flat)
    tx, _ = j_build_optimizer(cfg, params)
    state = tx.init(params)
    out = []
    for grads in grads_seq:
        updates, state = tx.update(_nest(grads), state, params)
        params = optax.apply_updates(params, updates)
        out.append(flatten_params(jax.tree.map(np.asarray, params)))
    return out


@pytest.mark.parametrize("wd", [False, True], ids=["wd0", "wd1e-4"])
@pytest.mark.parametrize("freeze_at", [0, 2])
@pytest.mark.parametrize("sched", ["WarmupPolyLR", "WarmupCosineLR"])
@pytest.mark.parametrize("opt", ["ADAM", "ADAMW", "SGD"])
def test_optimizer_matches_the_optax_chain(opt, sched, freeze_at, wd):
    rng = np.random.RandomState(7)
    flat = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads_seq = [{k: (rng.randn(*s) * g).astype(np.float32)
                  for k, s in SHAPES.items()} for g in GRAD_SCALES]
    jcfg = j_default_config()
    jcfg.defrost()
    want = _optax_run(_configure(jcfg, opt, sched, freeze_at, wd), flat,
                      grads_seq)

    cfg = _configure(get_default_config(), opt, sched, freeze_at, wd)
    tparams = {torch_key(k): torch.nn.Parameter(_torch_layout(v))
               for k, v in flat.items()}
    optimizer = build_optimizer(cfg, list(tparams.items()))
    start = {k: v.detach().clone() for k, v in tparams.items()}
    for step, grads in enumerate(grads_seq):
        for k, g in grads.items():
            tparams[torch_key(k)].grad = _torch_layout(g)
        optimizer.step()
        got = to_jax_arrays(tparams)
        for k, w in want[step].items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6,
                                       err_msg=f"step {step}: {k}")

    # the stem and res2 of the backbone; never the PoseCNN encoder's
    want_frozen = {torch_key(k) for k in SHAPES if freeze_at == 2
                   and k.startswith(("model/backbone/stem",
                                     "model/backbone/res2_"))}
    assert len(want_frozen) == (5 if freeze_at == 2 else 0)
    assert {n for n, f in zip(optimizer.names, optimizer.frozen)
            if f} == want_frozen
    for i, name in enumerate(optimizer.names):
        if name in want_frozen:
            assert torch.equal(tparams[name].detach(), start[name]), name
            assert float(optimizer.mu[i].abs().sum()) > 0, name
            if opt != "SGD":
                assert float(optimizer.nu[i].abs().sum()) > 0, name


def test_cosine_schedule_is_not_clamped_past_max_iter():
    s = warmup_cosine_schedule(1.0, 10, warmup_factor=1.0, warmup_iters=1)
    assert s(10) == pytest.approx(0.0, abs=1e-12)
    assert s(15) == pytest.approx(0.5)
    assert s(20) == pytest.approx(1.0)


def test_unknown_optimizer_and_scheduler_raise():
    params = [("w.weight", torch.nn.Parameter(torch.zeros(2)))]
    cfg = get_default_config()
    cfg.SOLVER.OPTIMIZER = "RMSPROP"
    with pytest.raises(ValueError, match="RMSPROP"):
        build_optimizer(cfg, params)
    cfg = get_default_config()
    cfg.SOLVER.LR_SCHEDULER_NAME = "StepLR"
    with pytest.raises(ValueError, match="StepLR"):
        build_optimizer(cfg, params)
