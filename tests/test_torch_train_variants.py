"""The port's training step in the configurations the shipped YAML files
and the solver options give, against the JAX package's step, in float32
on the CPU: (a) a panoptic-only model (``WITH_DEPTH: False``, as
configs/MGNet-Cityscapes-PseudoLabelGeneration.yaml) with SGD, FREEZE_AT 2
and WarmupCosineLR at batch 2; (b) the joint model with GRAD_ACCUM_STEPS
2, MODEL.REMAT and ADAMW at batch 4. Each JAX step is compiled once, in a
module-scoped fixture, with the widths and bars of
test_torch_train_step.py.

Then, with no JAX step: the port's REMAT step against its own step
without REMAT, bit for bit (losses, gradients, BN running statistics and
parameters), with the kernels' plain versions called as often as the
configuration implies; and a depth-only eval forward against the JAX
model's.
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
from mgnet_tpu.train.step import make_eval_step as j_make_eval_step
from mgnet_tpu.train.step import make_train_step as j_make_train_step
from mgnet_tpu.utils.weights import flatten_params
from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.data import synthetic_train_batch
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.models.abn import ABN
from mgnet_tpu_torch.ops import ssim as t_ssim
from mgnet_tpu_torch.ops import warp as t_warp
from mgnet_tpu_torch.train import (
    create_train_state as t_create_train_state,
    make_eval_step,
    make_train_step,
)
from mgnet_tpu_torch.utils.weights import load_jax_params, to_jax_arrays
from test_torch_models import randomized  # tests/ is on sys.path
from test_torch_train_step import (
    GRAD_COS_DIST,
    GRAD_COS_DIST_MEDIAN,
    LOSS_RTOL,
    _apply_widths,
    _randomized,
)

H = W = 64
VARIANTS = {
    "panoptic_sgd_freeze_cosine": dict(
        batch=2, WITH_DEPTH=False, OPTIMIZER="SGD", FREEZE_AT=2,
        LR_SCHEDULER_NAME="WarmupCosineLR", GRAD_ACCUM_STEPS=1,
        REMAT=False),
    "joint_accum2_remat_adamw": dict(
        batch=4, WITH_DEPTH=True, OPTIMIZER="ADAMW", FREEZE_AT=0,
        LR_SCHEDULER_NAME="WarmupPolyLR", GRAD_ACCUM_STEPS=2, REMAT=True),
}


def _configure(cfg, v):
    _apply_widths(cfg)
    cfg.WITH_DEPTH = v["WITH_DEPTH"]
    cfg.MODEL.REMAT = v["REMAT"]
    cfg.MODEL.BACKBONE.FREEZE_AT = v["FREEZE_AT"]
    s = cfg.SOLVER
    s.OPTIMIZER = v["OPTIMIZER"]
    s.LR_SCHEDULER_NAME = v["LR_SCHEDULER_NAME"]
    s.GRAD_ACCUM_STEPS = v["GRAD_ACCUM_STEPS"]
    s.WEIGHT_DECAY = 1e-4
    return cfg


def _store_grads() -> optax.GradientTransformation:
    """Keeps the gradients it is handed in its state; passes them on."""

    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    def update(updates, state, params=None):
        return updates, {"g": updates}

    return optax.GradientTransformation(init, update)


def _batch(v):
    batch = synthetic_train_batch(v["batch"], H, W, seed=5)
    return {k: val for k, val in batch.items() if k != "camera_height"}


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=list(VARIANTS))
def jax_run(request):
    """One f32 JAX train step of the variant from seeded variables: its
    metrics, the gradients its optimizer was handed, and the variables
    before and after."""
    v = VARIANTS[request.param]
    cfg = j_default_config()
    cfg.defrost()
    _configure(cfg, v)
    cfg.MODEL.DEPTH_HEAD.USE_PALLAS_WARP = False
    cfg.MODEL.DEPTH_HEAD.USE_PALLAS_SSIM = False
    cfg.MODEL.DEPTH_HEAD.PALLAS_WARP_FAST = False
    cfg.freeze()
    model = j_build_model(cfg)
    state = create_train_state(cfg, model, jax.random.PRNGKey(0),
                               sample_shape=(1, H, W, 3), tx=_store_grads())
    params = _randomized(state.params, 1)
    tx = optax.chain(_store_grads(), j_build_optimizer(cfg, params)[0])
    state = state.replace(params=params, tx=tx, opt_state=tx.init(params))
    batch = _batch(v)
    new_state, metrics = jax.jit(j_make_train_step(cfg, model))(
        state, {k: jnp.asarray(val) for k, val in batch.items()})

    def stats(tree):
        return {"model/" + k: val for k, val in flatten_params(tree).items()}

    return dict(
        variant=v,
        batch=batch,
        variables={**flatten_params(state.params),
                   **stats(state.batch_stats)},
        metrics={k: float(val) for k, val in metrics.items()},
        grads=flatten_params(new_state.opt_state[0]["g"]),
        params_after=flatten_params(new_state.params),
        stats_after=stats(new_state.batch_stats),
    )


def _cos_dists(got, want):
    dists = {}
    for k, w in want.items():
        a = got[k].astype(np.float64).ravel()
        b = w.astype(np.float64).ravel()
        den = np.linalg.norm(a) * np.linalg.norm(b)
        dists[k] = 0.0 if den == 0 and np.allclose(a, b) else \
            1.0 - float(a @ b) / den
    return dists


def test_train_step_matches_jax(jax_run):
    """Every metric, the gradient of every leaf by cosine, the BN running
    statistics after the step, and the parameters after it: FREEZE_AT's
    leaves unchanged on both sides, SGD's update as JAX's."""
    jr = jax_run
    v = jr["variant"]
    cfg = _configure(get_default_config(), v)
    model = build_model(cfg, device="cpu", for_training=True)
    state = t_create_train_state(cfg, model)
    state.params.load_state_dict(
        load_jax_params(jr["variables"], state.params))
    assert hasattr(model, "pose_net") == v["WITH_DEPTH"]
    assert hasattr(model, "sem_seg_head")
    _, metrics = make_train_step(cfg)(state, _tensors(jr["batch"]))

    assert set(metrics) - {"grad_norm"} == set(jr["metrics"])
    n_losses = 5 if v["WITH_DEPTH"] else 3
    assert len([k for k in metrics if k.endswith("_raw")]) == n_losses
    for k, want in jr["metrics"].items():
        assert float(metrics[k]) == pytest.approx(
            want, rel=LOSS_RTOL, abs=1e-7), k

    grads = to_jax_arrays({n: p.grad for n, p in
                           state.params.named_parameters()})
    assert set(grads) == set(jr["grads"])
    dists = _cos_dists(grads, jr["grads"])
    worst = max(dists, key=dists.get)
    median = float(np.median(list(dists.values())))
    print(f"gradient cosine distance: worst {worst} {dists[worst]:.3e}, "
          f"median {median:.3e} over {len(dists)} leaves")
    assert dists[worst] < GRAD_COS_DIST, (worst, dists[worst])
    assert median < GRAD_COS_DIST_MEDIAN
    # log_vars beyond the losses that exist get no gradient
    assert not grads["log_vars"][n_losses:].any()

    after = state.params.state_dict()
    stats = to_jax_arrays({k: t for k, t in after.items()
                           if k.endswith(("running_mean", "running_var"))})
    assert set(stats) == set(jr["stats_after"])
    for k, want in jr["stats_after"].items():
        np.testing.assert_allclose(stats[k], want, rtol=1e-3, atol=1e-5,
                                   err_msg=k)

    params = to_jax_arrays({n: p for n, p in
                            state.params.named_parameters()})
    frozen = [k for k in params if k.startswith(
        ("model/backbone/stem", "model/backbone/res2_"))] \
        if v["FREEZE_AT"] == 2 else []
    assert bool(frozen) == (v["FREEZE_AT"] == 2)
    for k in frozen:
        np.testing.assert_array_equal(params[k], jr["variables"][k], k)
        np.testing.assert_array_equal(jr["params_after"][k],
                                      jr["variables"][k], k)
    # the update itself, where it is linear in the gradient (SGD). Adam's
    # first update is ~ lr * sign(g), which follows f32 noise where an
    # element of g is near 0; test_torch_solver.py holds the chains
    if v["OPTIMIZER"] == "SGD":
        for k, want in jr["params_after"].items():
            np.testing.assert_allclose(params[k], want, rtol=0, atol=1e-6,
                                       err_msg=k)
    assert state.optimizer.count == 1 and state.step == 1


def _small_cfg(remat, accum, depth=True):
    cfg = _apply_widths(get_default_config())
    cfg.WITH_DEPTH = depth
    cfg.MODEL.REMAT = remat
    cfg.SOLVER.GRAD_ACCUM_STEPS = accum
    return cfg


def _port_step(cfg, batch, monkeypatch):
    """One port step from seeded weights, counting the calls of the plain
    kernel versions and of ABN forwards."""
    calls = {"warp": 0, "ssim_fwd": 0, "ssim_bwd": 0, "abn": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    for mod, attr, name in (
            (t_warp, "warp_bilinear_reference", "warp"),
            (t_ssim, "ssim_residual_reference", "ssim_fwd"),
            (t_ssim, "ssim_residual_bwd_reference", "ssim_bwd")):
        monkeypatch.setattr(mod, attr, counted(name, getattr(mod, attr)))
    model = build_model(cfg, device="cpu", for_training=True)
    init_random_(model, torch.Generator().manual_seed(3))
    for m in model.modules():
        if isinstance(m, ABN):
            m.register_forward_hook(
                lambda *_: calls.__setitem__("abn", calls["abn"] + 1))
    state = t_create_train_state(cfg, model)
    _, metrics = make_train_step(cfg)(state, _tensors(batch))
    monkeypatch.undo()
    return (metrics, {n: p.grad.clone() for n, p in
                      state.params.named_parameters()},
            {k: t.clone() for k, t in state.params.state_dict().items()},
            calls)


@pytest.mark.parametrize("accum,depth", [(1, True), (2, True), (1, False)],
                         ids=["joint", "joint_accum2", "panoptic"])
def test_remat_step_equals_the_plain_step_bit_for_bit(accum, depth,
                                                      monkeypatch):
    batch = synthetic_train_batch(4, 32, 32, seed=2)
    plain = _port_step(_small_cfg(False, accum, depth), batch, monkeypatch)
    remat = _port_step(_small_cfg(True, accum, depth), batch, monkeypatch)
    for what, a, b in zip(("metrics", "gradients", "state"), plain, remat):
        assert a.keys() == b.keys(), what
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        assert not differ, (what, differ[:5])
    # per micro-batch: the warp per context frame and scale (2 x 3), the
    # SSIM forward per candidate (2 x 4), its backward per warped one
    # (2 x 3); REMAT runs the loss's forward again in the backward
    n = accum if depth else 0
    assert plain[3]["warp"] == 6 * n and remat[3]["warp"] == 12 * n
    assert plain[3]["ssim_fwd"] == 8 * n and remat[3]["ssim_fwd"] == 16 * n
    assert plain[3]["ssim_bwd"] == remat[3]["ssim_bwd"] == 6 * n
    # and recomputes the blocks' and heads' ABN forwards
    assert remat[3]["abn"] > plain[3]["abn"]


def test_depth_only_eval_forward_matches_jax():
    """A depth-only model (no semantic or instance head) through the eval
    step, full resolution, against the JAX eval step, eagerly."""
    x = np.random.RandomState(4).randint(0, 256, (1, H, W, 3)).astype(
        np.float32)
    jcfg = j_default_config()
    jcfg.defrost()
    _apply_widths(jcfg)
    jcfg.WITH_PANOPTIC = False
    jmodel = j_build_model(jcfg)
    variables = randomized(jmodel.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x)), 6)
    want = j_make_eval_step(jcfg, jmodel)(
        {"model": variables["params"]}, variables["batch_stats"],
        jnp.asarray(x))

    cfg = _apply_widths(get_default_config())
    cfg.WITH_PANOPTIC = False
    model = build_model(cfg, device="cpu")
    assert not hasattr(model, "sem_seg_head")
    flat = {**flatten_params(variables["params"]),
            **flatten_params(variables["batch_stats"])}
    model.load_state_dict(load_jax_params(flat, model))
    got = make_eval_step(cfg)(model, torch.from_numpy(x))
    assert set(got) == set(want) == {"depth", "inv_depth"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape == (1, H, W, 1), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
