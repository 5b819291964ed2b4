"""The port's random init against the JAX package's, conv kernel by kernel.

flax initialises the JAX training model once (full width, default config;
parameter shapes do not depend on the input size); the port's training
model is drawn by ``init_random_`` at four fixed seeds. Each of the 84 conv
kernels, mapped through ``utils.weights.torch_key``, must have the std of
its JAX counterpart: the ratio of the two (rms about zero, the port's pooled
over its seeds) within 1 +- 4 / sqrt(2 n), n the kernel's element count,
about three standard errors of the ratio of two such estimates. The
truncated LeCun predictors of the depth head must also stay within their
truncation, 2 sigma of the untruncated normal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgnet_tpu.config import get_default_config as j_default_config
from mgnet_tpu.models.mgnet import build_model as j_build_model
from mgnet_tpu.utils.weights import flatten_params
from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.models.abn import INITS
from mgnet_tpu_torch.utils.weights import jax_key

SEEDS = (0, 1, 2, 3)
TRUNCATED_STD = 0.87962566103423978


def _port_model(seed=None, opts=()):
    cfg = get_default_config()
    for key, value in opts:
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = getattr(node, p)
        setattr(node, leaf, value)
    model = build_model(cfg, device="cpu", for_training=True)
    if seed is not None:
        init_random_(model, torch.Generator().manual_seed(seed))
    return model


def _convs(model):
    return {name: m for name, m in model.named_modules()
            if isinstance(m, torch.nn.Conv2d)}


KERNELS = sorted(jax_key(f"{name}.weight") for name in _convs(_port_model()))


@pytest.fixture(scope="module")
def jax_kernels():
    cfg = j_default_config()
    cfg.defrost()
    cfg.MODEL.COMPUTE_DTYPE = "float32"
    cfg.freeze()
    model = j_build_model(cfg)
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = jax.jit(lambda rng: model.init(
        rng, dummy, method=type(model).forward_train, image_prev=dummy,
        image_next=dummy))(jax.random.PRNGKey(0))
    flat = flatten_params(variables["params"])
    return {k: np.asarray(v, np.float64) for k, v in flat.items()
            if k.endswith("/kernel")}


@pytest.fixture(scope="module")
def port_kernels():
    """{jax key: [the seeds' OIHW kernels as float64]}."""
    out = {}
    for seed in SEEDS:
        for name, conv in _convs(_port_model(seed)).items():
            out.setdefault(jax_key(f"{name}.weight"), []).append(
                conv.weight.detach().double().numpy())
    return out


def test_the_port_has_the_jax_models_conv_kernels(jax_kernels):
    assert len(KERNELS) == 84
    assert sorted(jax_kernels) == KERNELS


@pytest.mark.parametrize("key", KERNELS)
def test_kernel_std_matches_the_jax_init(jax_kernels, port_kernels, key):
    want = jax_kernels[key]
    got = port_kernels[key]
    assert got[0].shape == want.transpose(3, 2, 0, 1).shape
    n = want.size
    ratio = np.sqrt(np.mean([np.mean(w * w) for w in got])
                    / np.mean(want * want))
    assert abs(ratio - 1.0) <= 4.0 / np.sqrt(2 * n), (key, ratio)


@pytest.mark.parametrize("head", ["head0", "head1", "head2"])
def test_truncated_predictors_stay_within_two_sigma(port_kernels, head):
    got = port_kernels[f"depth_head/{head}/predictor/kernel"]
    fan_in = got[0].shape[1] * got[0].shape[2] * got[0].shape[3]
    sigma = np.sqrt(1.0 / fan_in) / TRUNCATED_STD
    for w in got:
        assert np.abs(w).max() <= 2.0 * sigma


def test_each_conv_records_its_jax_rule():
    rules = {jax_key(f"{n}.weight"): m.init
             for n, m in _convs(_port_model()).items()}
    kaiming, xavier = "kaiming_normal_fan_out", "mgnet_xavier_init"
    for key, rule in rules.items():
        branch = key.split("/")[0]
        if branch in ("backbone",) or key.startswith("pose_net/encoder"):
            assert rule == kaiming, key
        elif branch == "pose_net" or "/ffm/attention_conv" in key:
            assert rule == xavier, key
        elif branch == "depth_head":
            assert rule == ("lecun_normal" if key.endswith(
                "/predictor/kernel") else kaiming), key
        else:
            assert rule == xavier, key


@pytest.mark.parametrize("method", sorted(INITS))
def test_init_method_of_the_config_reaches_every_head(method):
    opts = [(f"MODEL.{h}.INIT_METHOD", method)
            for h in ("GCM", "SEM_SEG_HEAD", "INS_EMBED_HEAD", "DEPTH_HEAD")]
    convs = _convs(_port_model(opts=opts))
    for name, conv in convs.items():
        if name.startswith(("backbone", "pose_net")) \
                or ".ffm.attention_conv" in name:
            continue
        if name.endswith(".predictor"):
            want = ("mgnet_xavier_init" if method == "xavier"
                    else "lecun_normal")
        else:
            want = INITS[method]
        assert conv.init == want, name


def test_init_zeroes_biases_and_resets_abn():
    model = _port_model(0)
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
        elif name.endswith("abn.weight"):
            assert (p == 1).all(), name
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            assert not b.any(), name
        elif name.endswith("running_var"):
            assert (b == 1).all(), name


def test_same_seed_same_weights_other_seed_others():
    a, b, c = (_port_model(s).state_dict() for s in (5, 5, 6))
    key = "depth_head.head0.predictor.weight"
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[key], c[key])
