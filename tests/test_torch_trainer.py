"""The port's trainer (mgnet_tpu_torch/train/trainer.py) and its entry
point (tools/train_net.py) on the CPU, on a Cityscapes-layout mini tree at
a small width: N trainer iterations equal N direct make_train_step calls on
the same loader batches, bit for bit; checkpoints round-trip the whole
TrainState; resume continues the step count; the ImageNet npz graft counts
as the JAX function counts; a trained checkpoint grafts leaf by leaf; and
what is missing raises."""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_data import LOADER_OPTS  # noqa: E402

from mgnet_tpu.utils.weights import (  # noqa: E402
    load_pretrained_npz as j_load_pretrained_npz,
)

import mgnet_tpu_torch.data as tdata  # noqa: E402
import mgnet_tpu_torch.train.trainer as trainer_mod  # noqa: E402
from mgnet_tpu_torch.config import load_config  # noqa: E402
from mgnet_tpu_torch.data import TrainLoader, to_device  # noqa: E402
from mgnet_tpu_torch.models import build_model, init_random_  # noqa: E402
from mgnet_tpu_torch.tools import train_net  # noqa: E402
from mgnet_tpu_torch.train import create_train_state  # noqa: E402
from mgnet_tpu_torch.train.trainer import Trainer  # noqa: E402
from mgnet_tpu_torch.utils.checkpoint import (  # noqa: E402
    CheckpointManager,
    save_params,
)
from mgnet_tpu_torch.utils.weights import (  # noqa: E402
    load_pretrained_npz,
    to_jax_arrays,
)

ROOT = Path(__file__).resolve().parent.parent
FINE = str(ROOT / "configs" / "MGNet-Cityscapes-Fine.yaml")
NPZ = str(ROOT / "weights" / "imagenet_weights.npz")
ITERS = 3


def _opts(out, **extra):
    """Fine, cut to a small width, a batch of 2 of 64x96 crops and 3
    iterations, f32, on the mini tree."""
    opts = {"MODEL.GCM.GCM_CHANNELS": 32, "MODEL.COMPUTE_DTYPE": "float32",
            "MODEL.SEM_SEG_HEAD.OHEM_N_MIN": 2000, "MODEL.WEIGHTS": NPZ,
            "SOLVER.IMS_PER_BATCH": 2, "SOLVER.MAX_ITER": ITERS,
            "SOLVER.CHECKPOINT_PERIOD": 2, "SOLVER.WARMUP_ITERS": 2,
            "TEST.EVAL_PERIOD": 0, "OUTPUT_DIR": str(out),
            "WRITE_OUTPUT_TO_SUBDIR": False, "DATALOADER.NUM_WORKERS": 2,
            "DATALOADER.PREFETCH": 2, **LOADER_OPTS}
    for head in ("SEM_SEG_HEAD", "INS_EMBED_HEAD", "DEPTH_HEAD"):
        opts.update({f"MODEL.{head}.HEAD_CHANNELS": 32,
                     f"MODEL.{head}.FFM_CHANNELS": 48,
                     f"MODEL.{head}.ARM_CHANNELS": [32, 32],
                     f"MODEL.{head}.REFINE_CHANNELS": [32, 32]})
    opts.update(extra)
    return [str(x) for kv in opts.items() for x in kv]


def _argv(root, out, *flags, **extra):
    return ["--config-file", FINE, "--data-root", str(root), "--device",
            "cpu", *flags, *_opts(out, **extra)]


def _fresh_state(cfg):
    """The train state the trainer starts from: seeded init, the npz."""
    model = build_model(cfg, device="cpu", for_training=True)
    init_random_(model, torch.Generator().manual_seed(cfg.SEED))
    state = create_train_state(cfg, model)
    load_pretrained_npz(NPZ, state.params)
    return state


def _assert_same_state(a, b):
    sa, sb = a.params.state_dict(), b.params.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["names"] == ob["names"] and oa["count"] == ob["count"]
    for x, y in zip(oa["mu"] + oa["nu"], ob["mu"] + ob["nu"]):
        assert torch.equal(x, y)
    assert a.step == b.step


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: CPU kernels then partition their reductions the
    same way whatever else runs (the trainer's loader threads do), so that
    a step is bit-reproducible."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory, one_thread):
    """One train_net run of 3 iterations; the batches its step was given."""
    root = tmp_path_factory.mktemp("trainer")
    tdata.DatasetCatalog.clear()
    tdata.MetadataCatalog.clear()
    tdata.write_cityscapes_tree(str(root), 4, 96, 192, seed=11)
    seen = []
    make = trainer_mod.make_train_step

    def recording(cfg):
        step = make(cfg)

        def call(state, batch):
            seen.append({k: v.clone() for k, v in batch.items()})
            return step(state, batch)
        return call

    trainer_mod.make_train_step = recording
    try:
        trainer = train_net.main(_argv(root, root / "out"))
    finally:
        trainer_mod.make_train_step = make
    return root, trainer, seen


def test_iterations_equal_direct_steps_on_the_loader_batches(run):
    root, trainer, seen = run
    cfg = trainer.cfg
    assert len(seen) == ITERS and trainer.state.step == ITERS
    # the batches are the loader's for the seed, from epoch 0
    loader = TrainLoader(
        tdata.DatasetCatalog.get(cfg.DATASETS.TRAIN[0]),
        tdata.TrainDatasetMapper(cfg), batch_size=2, seed=cfg.SEED,
        num_workers=2, prefetch=2)
    it = iter(loader)
    for b in seen:
        want = to_device(next(it), "cpu")
        assert b.keys() == want.keys()
        for k in b:
            assert b[k].dtype == want[k].dtype and torch.equal(b[k],
                                                               want[k]), k
    loader.close()
    state = _fresh_state(cfg)
    step = trainer_mod.make_train_step(cfg)
    for b in seen:
        step(state, b)
    _assert_same_state(trainer.state, state)


def test_outputs_metrics_and_checkpoints(run):
    root, trainer, _ = run
    out = root / "out"
    assert trainer.pretrained == {"matched": 200, "skipped": 0}
    assert sorted(os.listdir(out / "checkpoints")) == ["2.pt", "3.pt"]
    assert (out / "model_final" / "params.pt").is_file()
    assert load_config(str(out / "config.yaml")).SOLVER.MAX_ITER == ITERS
    lines = [json.loads(x) for x in (out / "metrics.json").read_text()
             .splitlines()]
    assert [x["iteration"] for x in lines] == [1]
    assert np.isfinite(lines[0]["loss_total"]) and "data_time" in lines[0]
    assert len(trainer.iter_seconds) == len(trainer.data_seconds) == ITERS


def test_checkpoint_round_trips_the_whole_state(run):
    root, trainer, _ = run
    state = _fresh_state(trainer.cfg)
    ckpt = CheckpointManager(str(root / "out" / "checkpoints"))
    assert ckpt.latest_step() == ITERS
    state, restored = ckpt.restore(state)
    assert restored
    _assert_same_state(state, trainer.state)


def test_checkpoint_manager_keeps_the_newest(tmp_path, run):
    _, trainer, _ = run
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=5)
    assert ckpt.restore(trainer.state) == (trainer.state, False)
    for s in range(1, 8):
        ckpt.save(s, trainer.state)
    assert ckpt.steps() == [3, 4, 5, 6, 7]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_resume_continues_the_step_count(run, tmp_path):
    root, trainer, _ = run
    out = tmp_path / "out"
    # a copy of the run's checkpoints, so that the run's stay as they are
    (out / "checkpoints").mkdir(parents=True)
    for n in ("2.pt", "3.pt"):
        (out / "checkpoints" / n).write_bytes(
            (root / "out" / "checkpoints" / n).read_bytes())
    args = train_net.parse_args(_argv(root, out, "--resume",
                                      **{"SOLVER.MAX_ITER": ITERS + 2}))
    cfg = train_net.setup(args)
    train_net.register_datasets(args)
    resumed = Trainer(cfg, device="cpu")
    resumed.resume_or_load(resume=True)
    assert resumed.pretrained is None  # resumed: no npz graft
    _assert_same_state(resumed.state, trainer.state)
    resumed.train()
    assert resumed.state.step == ITERS + 2
    assert CheckpointManager(str(out / "checkpoints")).steps() == [2, 3, 4, 5]
    lines = (out / "metrics.json").read_text().splitlines()
    assert json.loads(lines[0])["iteration"] == ITERS + 1


def _jax_trees(module):
    """The JAX package's params / batch_stats trees of a port module, as
    nested dicts of numpy arrays (batch_stats unrooted, as its
    TrainState holds them)."""
    params, stats = {}, {}
    for key, value in to_jax_arrays(module.state_dict()).items():
        is_stat = key.endswith("/mean") or key.endswith("/var")
        if is_stat:
            key = key[len("model/"):] if key.startswith("model/") else key
        node = stats if is_stat else params
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return params, stats


@pytest.mark.parametrize("which", ["train_params", "eval_model"])
def test_load_pretrained_npz_counts_equal_jax(run, which):
    cfg = run[1].cfg
    model = build_model(cfg, device="cpu", for_training=which != "eval_model")
    module = create_train_state(cfg, model).params if which == \
        "train_params" else model
    params, stats = _jax_trees(module)
    _, _, want = j_load_pretrained_npz(NPZ, params, stats)
    got = load_pretrained_npz(NPZ, module)
    assert got == want and got["matched"] > 0
    npz = np.load(NPZ)
    kernel = "backbone/res3_block0/conv1/conv/kernel"
    w = dict(module.named_parameters())[
        ("model." if which == "train_params" else "")
        + "backbone.res3_block0.conv1.conv.weight"]
    np.testing.assert_array_equal(w.detach().numpy(),
                                  npz[kernel].transpose(3, 2, 0, 1))


def test_trained_checkpoint_grafts_matching_leaves(run, tmp_path):
    root, trainer, _ = run
    # a 19-class model from Fine's 20-class model_final: the class head
    # keeps its fresh init, everything else comes from the checkpoint
    args = train_net.parse_args(_argv(
        root, tmp_path / "kitti", **{
            "MODEL.SEM_SEG_HEAD.NUM_CLASSES": 19,
            "MODEL.WEIGHTS": str(root / "out" / "model_final")}))
    cfg = train_net.setup(args)
    train_net.register_datasets(args)
    t = Trainer(cfg, device="cpu")
    fresh = {k: v.clone() for k, v in t.state.params.state_dict().items()}
    t.resume_or_load(resume=False)
    got = t.state.params.state_dict()
    src = trainer.state.params.state_dict()
    kept = [k for k in got if src[k].shape != got[k].shape]
    assert kept and all("sem_seg_head" in k for k in kept)
    for k in got:
        assert torch.equal(got[k], fresh[k] if k in kept else src[k]), k
    t.loader.close()

    save_params(str(tmp_path / "other"), torch.nn.Linear(3, 2))
    t.cfg.MODEL.WEIGHTS = str(tmp_path / "other")
    with pytest.raises(ValueError, match="matched zero"):
        t.resume_or_load(resume=False)


def test_what_is_missing_or_not_ported_raises(run, tmp_path):
    """Absent weights raise; so does evaluation on this tree, which has no
    val split: from the trainer's TEST.EVAL_PERIOD, from --eval-only and
    from Trainer.test."""
    root = run[0]
    with pytest.raises(FileNotFoundError, match="not found"):
        train_net.main(_argv(root, tmp_path / "a", **{
            "MODEL.WEIGHTS": str(tmp_path / "absent")}))
    missing = "cityscapes_panoptic_val.json"
    with pytest.raises(AssertionError, match=missing):
        train_net.main(_argv(root, tmp_path / "b", **{
            "TEST.EVAL_PERIOD": 1, "SOLVER.MAX_ITER": 1}))
    with pytest.raises(AssertionError, match=missing):
        train_net.main(["--eval-only", *_argv(root, tmp_path / "c")])
    with pytest.raises(AssertionError, match=missing):
        run[1].test()


def test_output_subdir_and_commit(run, tmp_path):
    args = train_net.parse_args(_argv(run[0], tmp_path, **{
        "WRITE_OUTPUT_TO_SUBDIR": True}))
    cfg = train_net.setup(args)
    assert Path(cfg.OUTPUT_DIR).parent == tmp_path
    assert Path(cfg.OUTPUT_DIR).name.endswith("_MGNet-Cityscapes-Fine")
    assert (Path(cfg.OUTPUT_DIR) / "config.yaml").is_file()
