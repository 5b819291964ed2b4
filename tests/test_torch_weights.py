"""The weight bridge: flat JAX 'path/leaf' arrays -> the port's modules."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgnet_tpu.models.mgnet import MGNet as JMGNet
from mgnet_tpu.utils.weights import flatten_params
from mgnet_tpu_torch.models.mgnet import MGNet
from mgnet_tpu_torch.models.resnet import ResNetABN
from mgnet_tpu_torch.utils.weights import load_jax_params, torch_key

SMALL = dict(gcm_channels=32, head_channels=32, ffm_channels=48,
             arm_channels=(32, 32), refine_channels=(32, 32))
NPZ = os.path.join(os.path.dirname(__file__), os.pardir, "weights",
                   "imagenet_weights.npz")


@pytest.mark.parametrize("jax_key,want", [
    ("backbone/stem/conv1/conv/kernel", "backbone.stem.conv1.conv.weight"),
    ("backbone/res2_block0/conv1/abn/BatchNorm_0/scale",
     "backbone.res2_block0.conv1.abn.weight"),
    ("global_context/conv/abn/BatchNorm_0/bias",
     "global_context.conv.abn.bias"),
    ("depth_head/head0/head/abn/BatchNorm_0/mean",
     "depth_head.head0.head.abn.running_mean"),
    ("sem_seg_head/decoder/ffm/conv/abn/BatchNorm_0/var",
     "sem_seg_head.decoder.ffm.conv.abn.running_var"),
    ("sem_seg_head/decoder/ffm/attention_conv1/kernel",
     "sem_seg_head.decoder.ffm.attention_conv1.weight"),
])
def test_torch_key(jax_key, want):
    assert torch_key(jax_key) == want


@pytest.fixture(scope="module")
def flax_flat():
    """The flax model's variable tree (shapes from ``jax.eval_shape``, no
    compile), filled with seeded numpy values."""
    model = JMGNet(num_classes=20, **SMALL)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda a: model.init(jax.random.PRNGKey(0), a, train=False), x)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    rng = np.random.RandomState(0)
    return {k: rng.randn(*v.shape).astype(np.float32)
            for col in ("params", "batch_stats")
            for k, v in flatten_params(zeros[col]).items()}


def test_every_flax_leaf_lands(flax_flat):
    model = MGNet(num_classes=20, **SMALL)
    sd = load_jax_params(flax_flat, model)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    k = "backbone/res3_block0/conv1/conv/kernel"
    np.testing.assert_array_equal(
        model.backbone.res3_block0.conv1.conv.weight.detach().numpy(),
        flax_flat[k].transpose(3, 2, 0, 1))


def test_raises_on_a_key_without_a_home(flax_flat):
    flat = dict(flax_flat)
    flat["backbone/res9_block0/conv1/conv/kernel"] = np.zeros((3, 3, 1, 1))
    with pytest.raises(ValueError, match="without a home"):
        load_jax_params(flat, MGNet(num_classes=20, **SMALL))


def test_raises_on_a_shape_mismatch(flax_flat):
    flat = dict(flax_flat)
    flat["global_context/conv/conv/kernel"] = np.zeros((1, 1, 512, 16))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_params(flat, MGNet(num_classes=20, **SMALL))


def test_raises_on_an_unset_parameter(flax_flat):
    flat = {k: v for k, v in flax_flat.items() if not k.endswith("/var")}
    with pytest.raises(ValueError, match="unset"):
        load_jax_params(flat, MGNet(num_classes=20, **SMALL))


def test_imagenet_backbone_loads():
    """weights/imagenet_weights.npz (backbone/* and pose_net/* keys) fills
    the port's backbone completely."""
    data = np.load(NPZ)
    flat = {k[len("backbone/"):]: data[k] for k in data.files
            if k.startswith("backbone/")}
    backbone = ResNetABN(depth=18)
    backbone.load_state_dict(load_jax_params(flat, backbone))
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = backbone.eval()(x)
    assert all(torch.isfinite(v).all() for v in out.values())
