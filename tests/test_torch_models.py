"""The port's modules against the JAX package's flax modules, in float32.

Parameters are initialised by flax, their BN scale/bias/statistics are
redrawn with numpy (so that a mis-mapped statistic shows), and they are
carried into the port by ``load_jax_params``, where every key must land.
Activations must agree to <= 1e-4 (the bar of tests/test_torch_parity.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgnet_tpu.models import layers as jl
from mgnet_tpu.models import resnet as jr
from mgnet_tpu.models.mgnet import MGNet as JMGNet
from mgnet_tpu.utils.weights import flatten_params, unflatten_params
from mgnet_tpu_torch.models import layers as tl
from mgnet_tpu_torch.models import resnet as tr
from mgnet_tpu_torch.models.mgnet import MGNet
from mgnet_tpu_torch.utils.weights import load_jax_params

ATOL = RTOL = 1e-4
SMALL = dict(gcm_channels=32, head_channels=32, ffm_channels=48,
             arm_channels=(32, 32), refine_channels=(32, 32))


def randomized(variables, seed):
    """Flax variables with BN scale/bias/mean/var redrawn from ``seed``."""
    rng = np.random.RandomState(seed)
    params = flatten_params(variables["params"])
    stats = flatten_params(variables.get("batch_stats", {}))
    for k, v in params.items():
        if k.endswith("BatchNorm_0/scale"):
            params[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("BatchNorm_0/bias"):
            params[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    for k, v in stats.items():
        if k.endswith("/mean"):
            stats[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        else:
            stats[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return {"params": unflatten_params(variables["params"], params),
            "batch_stats": unflatten_params(variables.get("batch_stats", {}),
                                            stats)}


def carried(variables, module):
    """Load flax ``variables`` into the torch ``module``; every key lands."""
    flat = {**flatten_params(variables["params"]),
            **flatten_params(variables["batch_stats"])}
    module.load_state_dict(load_jax_params(flat, module))
    return module.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close(torch_nchw, jax_nhwc, what):
    np.testing.assert_allclose(
        torch_nchw.detach().numpy().transpose(0, 2, 3, 1),
        np.asarray(jax_nhwc), atol=ATOL, rtol=RTOL,
        err_msg=f"activation drift in {what}")


def jax_run(jmod, seed, *xs, **kw):
    """Init (with redrawn BN) and apply a flax module in eval mode, each
    jitted once (far quicker on the CPU than op-by-op dispatch)."""
    init = jax.jit(lambda *a: jmod.init(jax.random.PRNGKey(seed), *a,
                                        train=False))
    variables = randomized(init(*xs), seed)
    apply = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False, **kw))
    return variables, apply(variables, *xs)


def pair(jmod, tmod, *xs, seed=0):
    """Run one flax module and its port on the same numpy NHWC inputs."""
    variables, y = jax_run(jmod, seed, *[jnp.asarray(x) for x in xs])
    with torch.no_grad():
        yt = carried(variables, tmod)(*[nchw(x) for x in xs])
    return y, yt


RNG = np.random.RandomState(11)


@pytest.mark.parametrize("hw", [(32, 48), (35, 49)])
def test_stem(hw):
    x = RNG.randn(2, *hw, 3).astype(np.float32)
    y, yt = pair(jr.BasicStem(), tr.BasicStem(), x)
    close(yt, y, "stem")


@pytest.mark.parametrize("cin,cout,stride", [(32, 64, 1), (32, 64, 2),
                                             (64, 64, 1)])
def test_basic_block(cin, cout, stride):
    x = RNG.randn(2, 12, 18, cin).astype(np.float32)
    y, yt = pair(jr.BasicBlock(cout, stride=stride),
                 tr.BasicBlock(cin, cout, stride), x)
    close(yt, y, f"basic_block({cin}->{cout}, s{stride})")


def test_gcm():
    x = RNG.randn(2, 5, 7, 48).astype(np.float32)
    y, yt = pair(jl.GlobalContextModule(32), tl.GlobalContextModule(48, 32),
                 x)
    close(yt, y, "gcm")


def test_arm():
    x = RNG.randn(2, 9, 13, 48).astype(np.float32)
    y, yt = pair(jl.AttentionRefinementModule(32),
                 tl.AttentionRefinementModule(48, 32), x)
    close(yt, y, "arm")


def test_ffm():
    fsp = RNG.randn(2, 9, 13, 40).astype(np.float32)
    fcp = RNG.randn(2, 9, 13, 24).astype(np.float32)
    y, yt = pair(jl.FeatureFusionModule(32), tl.FeatureFusionModule(64, 32),
                 fsp, fcp)
    close(yt, y, "ffm")


def test_head():
    x = RNG.randn(2, 9, 13, 40).astype(np.float32)
    y, yt = pair(jl.MGNetHead(24, 20), tl.MGNetHead(40, 24, 20), x)
    close(yt, y, "head")


def test_decoder():
    """Nearest upsamples between non-multiple sizes included."""
    feats = {
        "res5": RNG.randn(2, 2, 3, 512).astype(np.float32),
        "res4": RNG.randn(2, 4, 7, 256).astype(np.float32),
        "res3": RNG.randn(2, 9, 13, 128).astype(np.float32),
        "global_context": RNG.randn(2, 2, 3, 32).astype(np.float32),
    }
    jmod = jl.MGNetDecoder(arm_channels=(32, 32), refine_channels=(32, 24),
                           ffm_channels=40)
    tmod = tl.MGNetDecoder({"res3": 128, "res4": 256, "res5": 512},
                           (32, 32), (32, 24), 40)
    variables, (y, msc) = jax_run(
        jmod, 1, {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.no_grad():
        yt, msct = carried(variables, tmod)(
            {k: nchw(v) for k, v in feats.items()})
    close(yt, y, "decoder.fused")
    for i in range(2):
        close(msct[i], msc[i], f"decoder.msc{i}")


def test_resnet18():
    x = RNG.randn(1, 64, 96, 3).astype(np.float32)
    jmod, tmod = jr.ResNetABN(depth=18), tr.ResNetABN(depth=18)
    variables, y = jax_run(jmod, 2, jnp.asarray(x))
    with torch.no_grad():
        yt = carried(variables, tmod)(nchw(x))
    assert set(yt) == set(y) == {"res3", "res4", "res5"}
    for k in y:
        close(yt[k], y[k], k)


def test_mgnet_eval_outputs():
    """The whole network, heads at stride 8 (upsample=False)."""
    x = RNG.randn(1, 64, 128, 3).astype(np.float32)
    jmod = JMGNet(num_classes=20, **SMALL)
    variables, out = jax_run(jmod, 3, jnp.asarray(x), upsample=False)
    tmod = carried(variables, MGNet(num_classes=20, **SMALL))
    with torch.no_grad():
        ot = tmod(torch.from_numpy(x))
    assert set(ot) == set(out) == {"sem_seg", "center", "offset",
                                   "inv_depth", "depth"}
    for k in out:
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(out[k]),
                                   atol=ATOL, rtol=RTOL,
                                   err_msg=f"activation drift in {k}")


@pytest.mark.parametrize("for_training", [False, True])
def test_float64_reference_is_the_model_in_float64(for_training):
    """models.as_float64_ on a copy: every parameter and buffer in float64
    (the model it was copied from stays float32), forward or forward_train
    taking float32 frames, and each output within 1e-4 (norm-wise) of the
    float32 model's; the outputs the model casts to float32 (inverse
    depths, poses) stay float32, the rest are float64."""
    import copy

    from mgnet_tpu_torch.config import get_default_config
    from mgnet_tpu_torch.models import as_float64_, build_model, init_random_

    cfg = get_default_config()
    cfg.MODEL.COMPUTE_DTYPE = "float32"
    cfg.MODEL.GCM.GCM_CHANNELS = 32
    h = cfg.MODEL.SEM_SEG_HEAD
    h.ARM_CHANNELS, h.REFINE_CHANNELS = [32, 32], [32, 32]
    h.FFM_CHANNELS, h.HEAD_CHANNELS = 48, 32
    model = build_model(cfg, device="cpu", for_training=for_training)
    init_random_(model, torch.Generator().manual_seed(0))
    ref = as_float64_(copy.deepcopy(model))
    rng = np.random.RandomState(0)
    frames = [torch.from_numpy(rng.randn(2, 64, 128, 3).astype(np.float32))
              for _ in range(3 if for_training else 1)]
    with torch.no_grad():
        run = "forward_train" if for_training else "forward"
        got, want = (getattr(m, run)(*frames) for m in (model, ref))
    assert {t.dtype for t in ref.state_dict().values()
            if t.is_floating_point()} == {torch.float64}
    assert {t.dtype for t in model.state_dict().values()
            if t.is_floating_point()} == {torch.float32}
    if for_training:
        for out in (got, want):
            out.update({f"inv_depths/{i}": d
                        for i, d in enumerate(out.pop("inv_depths"))})
    assert set(got) == set(want)
    for key, w in want.items():
        kept = key.startswith(("inv_depth", "depth", "poses"))
        assert w.dtype == (torch.float32 if kept else torch.float64), key
        err = float((got[key].double() - w.double()).norm()
                    / w.double().norm())
        assert err < 1e-4, (key, err)

