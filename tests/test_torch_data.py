"""The port's data pipeline (mgnet_tpu_torch/data/) against the JAX
package's, bit for bit: dataset dicts and metadata of the Cityscapes and
KITTI registries, the train and test mappers under the same
np.random.Generator, the first TrainLoader batches for one seed, and the
hand-off of a batch to torch.

The JAX package's native image library is switched off here (its Pillow
and numpy paths give the same bits, tests/test_golden_mapper.py), so these
tests never build it."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.dirname(__file__))

from test_data import _make_mini_cityscapes  # noqa: E402
from test_golden_mapper import _make_fixture  # noqa: E402
from test_kitti import _make_mini_kitti  # noqa: E402

import mgnet_tpu.data as jdata  # noqa: E402
from mgnet_tpu.config import get_default_config as j_default_config  # noqa: E402
from mgnet_tpu.data import loader as jloader  # noqa: E402
from mgnet_tpu.data import native as jnative  # noqa: E402

import mgnet_tpu_torch.data as tdata  # noqa: E402
from mgnet_tpu_torch.config import get_default_config  # noqa: E402
from mgnet_tpu_torch.data import loader as tloader  # noqa: E402
from mgnet_tpu_torch.data.decode_cache import DecodeCache  # noqa: E402

TRAIN = "cityscapes_fine_scene_seg_train"


@pytest.fixture(autouse=True)
def jax_without_native(monkeypatch):
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)


def _clear():
    for pkg in (jdata, tdata):
        pkg.DatasetCatalog.clear()
        pkg.MetadataCatalog.clear()


@pytest.fixture
def registered(tmp_path):
    """Both packages' Cityscapes and KITTI registries over ``tmp_path``."""
    _clear()
    for pkg in (jdata, tdata):
        pkg.register_all_cityscapes_scene_seg(str(tmp_path))
        pkg.register_all_kitti_eigen_scene_seg(str(tmp_path))
    yield tmp_path
    _clear()


def _assert_same_sample(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray) or np.isscalar(v):
            g = np.asarray(got[k])
            assert g.dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(g, v, err_msg=k)
        else:
            assert got[k] == v, k


def _cfgs(**opts):
    """The same settings in the JAX and the port's config trees."""
    out = []
    for cfg in (j_default_config(), get_default_config()):
        cfg.INPUT.IGNORED_CATEGORIES_IN_DEPTH = ["ego vehicle", "sky"]
        for key, value in opts.items():
            node = cfg
            *path, leaf = key.split(".")
            for p in path:
                node = getattr(node, p)
            setattr(node, leaf, value)
        out.append(cfg)
    return out


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pseudo", [False, True])
def test_cityscapes_dicts_and_metadata_equal_jax(tmp_path, pseudo):
    _make_mini_cityscapes(str(tmp_path))
    _clear()
    for pkg in (jdata, tdata):
        pkg.register_all_cityscapes_scene_seg(str(tmp_path),
                                              pseudo_label_generation=pseudo)
    got = tdata.DatasetCatalog.get(TRAIN)
    assert got == jdata.DatasetCatalog.get(TRAIN) and got
    for name in jdata.DatasetCatalog.list():
        assert (tdata.MetadataCatalog.get(name).extra
                == jdata.MetadataCatalog.get(name).extra)
    assert tdata.DatasetCatalog.list() == jdata.DatasetCatalog.list()
    _clear()


@pytest.mark.parametrize("split,pseudo", [
    ("kitti_eigen_scene_seg_test", False),
    ("kitti_zhou_scene_seg_train", True),
])
def test_kitti_dicts_and_metadata_equal_jax(tmp_path, split, pseudo):
    _make_mini_kitti(str(tmp_path))
    _clear()
    for pkg in (jdata, tdata):
        pkg.register_all_kitti_eigen_scene_seg(str(tmp_path),
                                               pseudo_label_generation=pseudo)
    got = tdata.DatasetCatalog.get(split)
    assert got == jdata.DatasetCatalog.get(split) and got
    assert (tdata.MetadataCatalog.get(split).extra
            == jdata.MetadataCatalog.get(split).extra)
    _clear()


def test_catalog_refuses_a_second_registration():
    cat = type(tdata.DatasetCatalog)()
    cat.register("a", list)
    with pytest.raises(KeyError, match="already registered"):
        cat.register("a", list)
    with pytest.raises(KeyError, match="not registered"):
        cat.get("b")


# ---------------------------------------------------------------------------
# mappers
# ---------------------------------------------------------------------------

MAPPER_CASES = {
    # multi-scale down- and upscales, crops, flips, jitter
    "multiscale_crop_jitter": dict(**{
        "INPUT.MIN_SIZE_TRAIN": (64, 96, 160, 256),
        "INPUT.MAX_SIZE_TRAIN": 600, "INPUT.CROP.SIZE": (96, 128)}),
    # resized smaller than the crop: random padding to the crop size
    "pad_to_crop": dict(**{
        "INPUT.MIN_SIZE_TRAIN": (48, 57), "INPUT.MAX_SIZE_TRAIN": 256,
        "INPUT.CROP.SIZE": (96, 128)}),
    # no crop, no jitter, non-integer scale
    "nocrop_nojitter": dict(**{
        "INPUT.MIN_SIZE_TRAIN": (77, 141), "INPUT.MAX_SIZE_TRAIN": 400,
        "INPUT.CROP.ENABLED": False, "INPUT.COLOR_JITTER.ENABLED": False}),
}


@pytest.mark.parametrize("case", sorted(MAPPER_CASES))
def test_train_mapper_equals_jax(registered, case):
    d = _make_fixture(str(registered / "fix"))
    jcfg, tcfg = _cfgs(**MAPPER_CASES[case])
    jm = jdata.TrainDatasetMapper(jcfg, dataset_name=TRAIN)
    tm = tdata.TrainDatasetMapper(tcfg, dataset_name=TRAIN)
    for seed in range(4):
        want = jm(d, rng=np.random.default_rng(seed))
        got = tm(d, rng=np.random.default_rng(seed))
        _assert_same_sample(got, want)


def test_train_mapper_decode_cache_equals_jax(registered):
    d = _make_fixture(str(registered / "fix"))
    jcfg, tcfg = _cfgs(**MAPPER_CASES["multiscale_crop_jitter"])
    tcfg.DATALOADER.DECODE_CACHE_DIR = str(registered / "dc")
    want = jdata.TrainDatasetMapper(jcfg, dataset_name=TRAIN)(
        d, rng=np.random.default_rng(5))
    tm = tdata.TrainDatasetMapper(tcfg, dataset_name=TRAIN)
    for _ in range(2):  # misses, then hits of the port's own entries
        _assert_same_sample(tm(d, rng=np.random.default_rng(5)), want)
    assert len(os.listdir(registered / "dc")) == 4  # 4 distinct PNGs


@pytest.mark.parametrize("min_size", [0, 96, 200])
def test_test_mapper_equals_jax(registered, min_size):
    d = _make_fixture(str(registered / "fix"))
    jcfg, tcfg = _cfgs(**{"INPUT.MIN_SIZE_TEST": min_size,
                          "INPUT.MAX_SIZE_TEST": 320})
    want = jdata.TestDatasetMapper(jcfg)(d)
    got = tdata.TestDatasetMapper(tcfg)(d)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_decode_cache_entries_and_invalidation(tmp_path):
    p = str(tmp_path / "img.png")
    a = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    Image.fromarray(a).save(p)
    cache = DecodeCache(str(tmp_path / "dc"))
    np.testing.assert_array_equal(np.asarray(cache.get(p)), a)
    b = a[::-1].copy()
    Image.fromarray(b).save(p)
    os.utime(p, ns=(1, 1))
    np.testing.assert_array_equal(np.asarray(cache.get(p)), b)
    arr = cache.get(p)
    with pytest.raises(ValueError):
        arr[0, 0, 0] = 1
    assert len(os.listdir(tmp_path / "dc")) == 2


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------


LOADER_OPTS = {"INPUT.MIN_SIZE_TRAIN": (64, 96, 128),
               "INPUT.MAX_SIZE_TRAIN": 400, "INPUT.CROP.SIZE": (64, 96)}


def test_train_loader_first_batches_equal_jax(registered):
    tdata.write_cityscapes_tree(str(registered), 4, 96, 192, seed=11)
    jcfg, tcfg = _cfgs(**LOADER_OPTS)
    dicts = jdata.DatasetCatalog.get(TRAIN)
    assert tdata.DatasetCatalog.get(TRAIN) == dicts and len(dicts) == 4
    batches = []
    for pkg, mod, cfg in ((jdata, jloader, jcfg), (tdata, tloader, tcfg)):
        loader = mod.TrainLoader(
            pkg.DatasetCatalog.get(TRAIN),
            pkg.TrainDatasetMapper(cfg, dataset_name=TRAIN),
            batch_size=3, seed=5, num_workers=3, prefetch=2)
        it = iter(loader)
        batches.append([next(it) for _ in range(3)])
        loader.close()
    for want, got in zip(*batches):
        _assert_same_sample(got, want)


def test_to_device_keeps_the_collation_key_by_key(registered):
    """The hand-off to torch: every key of the JAX collation, each with
    its dtype and values."""
    tdata.write_cityscapes_tree(str(registered), 4, 96, 192, seed=11)
    jcfg, _ = _cfgs(**LOADER_OPTS)
    m = jdata.TrainDatasetMapper(jcfg, dataset_name=TRAIN)
    dicts = jdata.DatasetCatalog.get(TRAIN)
    samples = [m(d, rng=np.random.default_rng(i)) for i, d in
               enumerate(dicts[:2])]
    for s in samples:
        s.pop("image_id")
    want = jloader.collate_batch(samples, 32)
    got = tloader.to_device(tloader.collate_batch(samples, 32), "cpu")
    assert list(got) == list(want)
    for k, v in want.items():
        assert isinstance(got[k], torch.Tensor), k
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_train_loader_raises_the_mappers_error_and_one_process_only():
    def broken(d, rng):
        raise OSError("unreadable")

    loader = tloader.TrainLoader([{}], broken, batch_size=1, num_workers=1)
    with pytest.raises(RuntimeError, match="producer failed") as err:
        next(iter(loader))
    assert isinstance(err.value.__cause__, OSError)
    loader.close()
    assert not loader._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        next(iter(loader))
    # several processes: the global batch must divide over them
    with pytest.raises(ValueError, match="does not divide"):
        tloader.TrainLoader([{}], broken, batch_size=3, process_count=2)


def test_pad_to_divisible_and_collate_equal_jax():
    rng = np.random.RandomState(0)
    samples = [{"sem_seg": rng.randint(0, 19, (30, 45)).astype(np.int32),
                "image": rng.randint(0, 255, (30, 45, 3)).astype(np.uint8),
                "camera_matrix": np.eye(3, dtype=np.float32),
                "camera_height": np.float32(1.2), "image_id": "a"}
               for _ in range(2)]
    samples[1]["sem_seg"] = samples[1]["sem_seg"][:20]
    samples[1]["image"] = samples[1]["image"][:20]
    _assert_same_sample(tloader.collate_batch(samples, 32),
                        jloader.collate_batch(samples, 32))
    a = rng.rand(33, 17, 2)
    np.testing.assert_array_equal(tloader.pad_to_divisible(a, 16, 3.0),
                                  jloader.pad_to_divisible(a, 16, 3.0))
