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
from mgnet_tpu_torch.train.state import TrainParams
from mgnet_tpu_torch.utils.weights import (
    jax_key,
    load_jax_params,
    to_jax_arrays,
    torch_key,
)

SMALL = dict(gcm_channels=32, head_channels=32, ffm_channels=48,
             arm_channels=(32, 32), refine_channels=(32, 32))
NPZ = os.path.join(os.path.dirname(__file__), os.pardir, "weights",
                   "imagenet_weights.npz")


@pytest.mark.parametrize("key,want", [
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
    ("model/pose_net/conv4/bias", "model.pose_net.conv4.bias"),
    ("model/pose_net/encoder/stem/conv1/conv/kernel",
     "model.pose_net.encoder.stem.conv1.conv.weight"),
    ("model/depth_head/head2/head/abn/BatchNorm_0/var",
     "model.depth_head.head2.head.abn.running_var"),
    ("log_vars", "log_vars"),
])
def test_torch_key(key, want):
    assert torch_key(key) == want
    assert jax_key(want) == key


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


@pytest.fixture(scope="module")
def flax_train_flat():
    """The variable tree of a flax model initialised through forward_train
    (pose net, multi-scale depth heads) plus the train state's log_vars,
    as 'model/...' keys, filled with seeded numpy values."""
    model = JMGNet(num_classes=20, **SMALL)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda a: model.init(
        jax.random.PRNGKey(0), a, a, a,
        method=type(model).forward_train), x)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    rng = np.random.RandomState(1)
    flat = {"model/" + k: rng.randn(*v.shape).astype(np.float32)
            for col in ("params", "batch_stats")
            for k, v in flatten_params(zeros[col]).items()}
    flat["log_vars"] = rng.randn(5).astype(np.float32)
    return flat


def test_training_tree_lands_and_comes_back(flax_train_flat):
    """Every leaf of the training tree (pose net, head1/head2, log_vars)
    lands in TrainParams, and to_jax_arrays gives back the same keys and
    arrays."""
    params = TrainParams(MGNet(num_classes=20, for_training=True, **SMALL))
    params.load_state_dict(load_jax_params(flax_train_flat, params))
    for k in ("model/pose_net/conv1/kernel", "model/pose_net/conv4/bias",
              "model/depth_head/head1/predictor/kernel",
              "model/depth_head/head2/head/abn/BatchNorm_0/mean",
              "log_vars"):
        assert k in flax_train_flat
    back = to_jax_arrays(params.state_dict())
    assert set(back) == set(flax_train_flat)
    for k, v in flax_train_flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert params.model.pose_net.encoder.stem.conv1.conv.weight.shape[1] == 9


def test_eval_model_has_no_training_modules(flax_train_flat):
    """An eval model has no pose net and no head1/head2, as a flax model
    initialised for eval has none: the training tree's extra keys have no
    home there."""
    flat = {k[len("model/"):]: v for k, v in flax_train_flat.items()
            if k.startswith("model/")}
    with pytest.raises(ValueError, match="without a home"):
        load_jax_params(flat, MGNet(num_classes=20, **SMALL))


def test_imagenet_pose_encoder_loads():
    """weights/imagenet_weights.npz's pose_net/encoder/* keys fill the pose
    net's 9-channel encoder completely."""
    data = np.load(NPZ)
    prefix = "pose_net/encoder/"
    flat = {k[len(prefix):]: data[k] for k in data.files
            if k.startswith(prefix)}
    encoder = ResNetABN(depth=18, in_channels=9, out_features=("res5",))
    encoder.load_state_dict(load_jax_params(flat, encoder))
    x = torch.randn(1, 9, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = encoder.eval()(x)
    assert set(out) == {"res5"} and torch.isfinite(out["res5"]).all()
