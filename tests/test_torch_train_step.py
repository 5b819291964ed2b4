"""The port's training step against the JAX package's, in float32 on the
CPU: the training forward, the BN running statistics, one full step's
losses and per-leaf gradients, and the optimizer over three steps.

Both sides start from the same variables: flax initialises them (with BN
scale/bias redrawn by numpy so that a mis-mapped leaf shows) and
``load_jax_params`` carries them into the port. Every JAX compile happens
once, in a module-scoped fixture.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgnet_tpu.config import get_default_config as j_default_config
from mgnet_tpu.models.mgnet import build_model as j_build_model
from mgnet_tpu.solver import build_optimizer as j_build_optimizer
from mgnet_tpu.train.state import create_train_state
from mgnet_tpu.train.step import make_train_step as j_make_train_step
from mgnet_tpu.train.step import normalize_images as j_normalize
from mgnet_tpu.utils.weights import flatten_params, unflatten_params
from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.data import synthetic_train_batch
from mgnet_tpu_torch.models import build_model
from mgnet_tpu_torch.solver import build_optimizer
from mgnet_tpu_torch.train import (
    TrainParams,
    create_train_state as t_create_train_state,
    make_train_step,
    normalize_images,
)
from mgnet_tpu_torch.utils.weights import (
    load_jax_params,
    to_jax_arrays,
    torch_key,
)

B, H, W = 2, 64, 64
WIDTHS = dict(GCM=32, HEAD=32, FFM=48, ARM=[32, 32], REFINE=[32, 32])
# losses: f32 through two ResNet-18s, three decoders and the photometric
# warps, evaluated by XLA and by oneDNN/ATen in other orders
LOSS_RTOL = 2e-4
# per-leaf gradient cosine distance 1 - cos. At batch 2 the pooled
# [B, C, 1, 1] BN sites normalise over 2 values, which amplifies f32
# rounding (tests/test_golden_train_step.py measures 1-9% per-loss
# gradient-norm scatter there). Measured on this fixture: worst leaf
# 2.5e-4 (a decoder BN bias), median 2.3e-9 over 225 leaves
GRAD_COS_DIST = 2e-3
GRAD_COS_DIST_MEDIAN = 1e-6


def _apply_widths(cfg):
    for head in (cfg.MODEL.SEM_SEG_HEAD, cfg.MODEL.INS_EMBED_HEAD,
                 cfg.MODEL.DEPTH_HEAD):
        head.HEAD_CHANNELS = WIDTHS["HEAD"]
        head.FFM_CHANNELS = WIDTHS["FFM"]
        head.ARM_CHANNELS = list(WIDTHS["ARM"])
        head.REFINE_CHANNELS = list(WIDTHS["REFINE"])
    cfg.MODEL.GCM.GCM_CHANNELS = WIDTHS["GCM"]
    cfg.MODEL.COMPUTE_DTYPE = "float32"
    cfg.MODEL.SEM_SEG_HEAD.OHEM_N_MIN = 3000
    cfg.SOLVER.WARMUP_ITERS = 10
    cfg.SOLVER.MAX_ITER = 100
    return cfg


def _jax_cfg():
    cfg = j_default_config()
    cfg.defrost()
    _apply_widths(cfg)
    cfg.MODEL.DEPTH_HEAD.USE_PALLAS_WARP = False
    cfg.MODEL.DEPTH_HEAD.USE_PALLAS_SSIM = False
    cfg.freeze()
    return cfg


def _capture_grads() -> optax.GradientTransformation:
    """An optax 'optimizer' that keeps the gradients it is handed and
    leaves the parameters alone."""

    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    def update(updates, state, params=None):
        return jax.tree.map(jnp.zeros_like, updates), {"g": updates}

    return optax.GradientTransformation(init, update)


def _randomized(params, seed):
    rng = np.random.RandomState(seed)
    flat = flatten_params(params)
    for k, v in flat.items():
        if k.endswith("BatchNorm_0/scale"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("BatchNorm_0/bias"):
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return unflatten_params(params, flat)


@pytest.fixture(scope="module")
def jax_run():
    """One f32 JAX train step from seeded variables: its metrics, its
    gradients, and the variables before and after."""
    cfg = _jax_cfg()
    model = j_build_model(cfg)
    state = create_train_state(cfg, model, jax.random.PRNGKey(0),
                               sample_shape=(1, H, W, 3),
                               tx=_capture_grads())
    state = state.replace(params=_randomized(state.params, 1))
    batch = synthetic_train_batch(B, H, W, seed=5)
    batch = {k: v for k, v in batch.items() if k != "camera_height"}
    new_state, metrics = jax.jit(j_make_train_step(cfg, model))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})

    # the raw training forward from the same variables
    norm = [j_normalize(jnp.asarray(batch[k]), cfg.MODEL.PIXEL_MEAN,
                        cfg.MODEL.PIXEL_STD)
            for k in ("image", "image_prev", "image_next")]
    fwd, mutated = jax.jit(lambda v, *x: model.apply(
        v, *x, method=type(model).forward_train,
        mutable=["batch_stats"]))(
        {"params": state.params["model"], "batch_stats": state.batch_stats},
        *norm)

    def stats(tree):
        return {"model/" + k: v for k, v in flatten_params(tree).items()}

    return dict(
        batch=batch,
        variables={**flatten_params(state.params),
                   **stats(state.batch_stats)},
        metrics={k: float(v) for k, v in metrics.items()},
        grads=flatten_params(new_state.opt_state["g"]),
        stats_after=stats(new_state.batch_stats),
        forward=jax.tree.map(np.asarray, fwd),
        forward_stats=stats(mutated["batch_stats"]),
    )


def _port(jr):
    cfg = _apply_widths(get_default_config())
    model = build_model(cfg, device="cpu", for_training=True)
    state = t_create_train_state(cfg, model)
    state.params.load_state_dict(
        load_jax_params(jr["variables"], state.params))
    return cfg, state


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def test_forward_train_and_running_stats_match(jax_run):
    """forward_train outputs and the BN running statistics after one
    training-mode forward."""
    jr = jax_run
    cfg, state = _port(jr)
    model = state.params.model.train()
    b = jr["batch"]

    jout = jr["forward"]
    tb = _tensors(b)
    with torch.no_grad():
        tout = model.forward_train(*[
            normalize_images(tb[k], cfg.MODEL.PIXEL_MEAN,
                             cfg.MODEL.PIXEL_STD)
            for k in ("image", "image_prev", "image_next")])
    for key in ("sem_seg", "center", "offset", "poses"):
        np.testing.assert_allclose(tout[key].numpy(), jout[key],
                                   rtol=1e-3, atol=1e-3, err_msg=key)
    assert len(tout["inv_depths"]) == len(jout["inv_depths"]) == 3
    for i, (t, j) in enumerate(zip(tout["inv_depths"], jout["inv_depths"])):
        assert t.shape == (B, H, W, 1) and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-3,
                                   atol=1e-5, err_msg=f"inv_depths[{i}]")
    want = jr["forward_stats"]
    got = to_jax_arrays({k: v for k, v in state.params.state_dict().items()
                         if k.endswith(("running_mean", "running_var"))})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def test_train_step_losses_and_gradients_match(jax_run):
    """One full f32 step at batch 2, 64x64: every loss and metric, and the
    gradient of every parameter leaf by cosine."""
    jr = jax_run
    cfg, state = _port(jr)
    _, metrics = make_train_step(cfg)(state, _tensors(jr["batch"]))
    for k, want in jr["metrics"].items():
        got = float(metrics[k])
        assert got == pytest.approx(want, rel=LOSS_RTOL, abs=1e-7), k
    grads = to_jax_arrays({n: p.grad for n, p in
                           state.params.named_parameters()})
    assert set(grads) == set(jr["grads"])
    dists = {}
    for k, want in jr["grads"].items():
        a = grads[k].astype(np.float64).ravel()
        b = want.astype(np.float64).ravel()
        den = np.linalg.norm(a) * np.linalg.norm(b)
        dists[k] = 0.0 if den == 0 and np.allclose(a, b) else \
            1.0 - float(a @ b) / den
    worst = max(dists, key=dists.get)
    print(f"gradient cosine distance: worst {worst} {dists[worst]:.3e}, "
          f"median {np.median(list(dists.values())):.3e} over "
          f"{len(dists)} leaves")
    assert dists[worst] < GRAD_COS_DIST, (worst, dists[worst])
    assert np.median(list(dists.values())) < GRAD_COS_DIST_MEDIAN
    # the step's forward updated the BN running statistics as JAX's did
    stats = to_jax_arrays({k: v for k, v in state.params.state_dict().items()
                           if k.endswith(("running_mean", "running_var"))})
    assert set(stats) == set(jr["stats_after"])
    for k, want in jr["stats_after"].items():
        np.testing.assert_allclose(stats[k], want, rtol=1e-3, atol=1e-5,
                                   err_msg=k)


OPT_SHAPES = {
    "model/backbone/stem/conv1/conv/kernel": (3, 3, 2, 4),
    "model/backbone/stem/conv1/abn/BatchNorm_0/scale": (4,),
    "model/backbone/stem/conv1/abn/BatchNorm_0/bias": (4,),
    "model/sem_seg_head/head/predictor/kernel": (1, 1, 4, 3),
    "model/depth_head/head0/head/abn/BatchNorm_0/scale": (4,),
    "model/pose_net/conv1/kernel": (1, 1, 4, 6),
    "model/pose_net/conv1/bias": (6,),
    "log_vars": (5,),
}
OPT_SOLVER = dict(WEIGHT_DECAY=1e-2, WEIGHT_DECAY_BIAS=2e-3,
                  WEIGHT_DECAY_NORM=5e-3, WARMUP_ITERS=2, MAX_ITER=10,
                  BASE_LR=1e-2)
OPT_CLIP = 1.0
# global gradient norms ~0.3, ~3, ~0.3 against the clip at 1.0
OPT_GRAD_SCALES = (0.1, 1.0, 0.1)


@pytest.fixture(scope="module")
def optax_run():
    """build_optimizer's optax chain over a small tree with head, non-head,
    norm, bias and log_vars leaves and all three weight decays non-zero,
    for 3 steps of seeded gradients: (initial params, [(grads, params
    after the step)])."""
    rng = np.random.RandomState(0)
    cfg = j_default_config()
    cfg.defrost()
    for key, value in OPT_SOLVER.items():
        setattr(cfg.SOLVER, key, value)
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = OPT_CLIP
    cfg.freeze()
    flat = {k: rng.randn(*s).astype(np.float32)
            for k, s in OPT_SHAPES.items()}
    params = _nest(flat)
    tx, _ = j_build_optimizer(cfg, params)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    steps = []
    for scale in OPT_GRAD_SCALES:
        grads = {k: (rng.randn(*s) * scale).astype(np.float32)
                 for k, s in OPT_SHAPES.items()}
        updates, opt_state = update(_nest(grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        steps.append((grads, flatten_params(params)))
    return flat, steps


def _torch_layout(a):
    return torch.from_numpy(
        a.transpose(3, 2, 0, 1).copy() if a.ndim == 4 else a.copy())


def test_optimizer_matches_the_optax_chain(optax_run):
    """The port's optimizer and build_optimizer's optax chain, fed the same
    gradients for 3 steps, with clipping on at some steps and off at
    others: parameters agree to 1e-6."""
    cfg = get_default_config()
    for key, value in OPT_SOLVER.items():
        setattr(cfg.SOLVER, key, value)
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = OPT_CLIP
    flat, steps = optax_run
    tparams = {torch_key(k): torch.nn.Parameter(_torch_layout(v))
               for k, v in flat.items()}
    opt = build_optimizer(cfg, list(tparams.items()))
    for step, (grads, want) in enumerate(steps):
        for k, g in grads.items():
            tparams[torch_key(k)].grad = _torch_layout(g)
        opt.step()
        got = to_jax_arrays(tparams)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6,
                                       err_msg=f"step {step}: {k}")


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


def test_grad_accumulation_is_refused():
    """Gradient accumulation runs (tests/test_torch_train_variants.py); a
    batch that does not divide into its micro-batches is refused before
    any forward."""
    cfg = _apply_widths(get_default_config())
    cfg.SOLVER.GRAD_ACCUM_STEPS = 2
    model = build_model(cfg, device="cpu", for_training=True)
    state = t_create_train_state(cfg, model)
    batch = _tensors(synthetic_train_batch(3, 32, 32, seed=0))
    with pytest.raises(ValueError, match="does not divide"):
        make_train_step(cfg)(state, batch)
    assert state.step == 0 and state.optimizer.count == 0


def test_train_params_hold_log_vars():
    cfg = _apply_widths(get_default_config())
    model = build_model(cfg, device="cpu", for_training=True)
    params = TrainParams(model)
    assert params.log_vars.shape == (5,)
    assert float(params.log_vars.detach().abs().sum()) == 0.0
