"""The port's evaluation slice as a whole against the JAX package's, on the
CPU, at a small size.

One flax-initialised model (BN redrawn, carried over by
``load_jax_params``) at the narrow widths of test_torch_fused.py, in
float32, evaluates a mini val tree on both sides: two frames of 64x128 and
two of 60x120 (a second bucket key: the same padded and valid shape, other
original sizes), at a test batch of 2, so the JAX eval step compiles once.
Stated bars:
* panoptic maps: equal on >= 99.9% of pixels (the JAX CPU clustering
  evaluates |p - c|^2, the port c^2 - 2 p.c, which round apart at near
  ties; an argmax near-tie may flip a class);
* metric dicts: the same keys; every value within 1e-4 relative (1e-4
  absolute below 1). The maps agree on every pixel of this tree, and the
  depth goes through the same f16 compaction on both sides.
``multi_scale_flip_inference`` is held to the JAX function with the 1e-4
bars of test_torch_fused.py. The rest is the port alone: padded batch
copies reach no evaluator, ``--eval-only`` and ``TEST.EVAL_PERIOD`` write
their metrics, and two gloo processes with half the samples each give the
one-process dict.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgnet_tpu.config import get_default_config as jax_config
from mgnet_tpu.data import catalog as jcatalog
from mgnet_tpu.data import native as jnative
from mgnet_tpu.data.cityscapes import (
    register_all_cityscapes_scene_seg as j_register,
)
from mgnet_tpu.inference.tta import (
    multi_scale_flip_inference as j_multi_scale_flip_inference,
)
from mgnet_tpu.models.mgnet import build_model as j_build_model
from mgnet_tpu.train.step import normalize_images as j_normalize
from mgnet_tpu.train.trainer import evaluate_dataset as j_evaluate_dataset
from mgnet_tpu.utils.weights import flatten_params

import mgnet_tpu_torch.data as tdata
from mgnet_tpu_torch.config import get_default_config
from mgnet_tpu_torch.inference.tta import multi_scale_flip_inference
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.tools import train_net
from mgnet_tpu_torch.train import create_train_state
from mgnet_tpu_torch.train.step import normalize_images
from mgnet_tpu_torch.train.trainer import evaluate_dataset
from mgnet_tpu_torch.utils import load_jax_params
from mgnet_tpu_torch.utils.checkpoint import save_params
from test_torch_fused import _configure  # tests/ is on sys.path
from test_torch_models import randomized

HERE = Path(__file__).resolve().parent
FINE = str(HERE.parent / "configs" / "MGNet-Cityscapes-Fine.yaml")
VAL_SIZES = [(64, 128), (64, 128), (60, 120), (60, 120)]
AGREE = 0.999
RTOL = ATOL = 1e-4
# the metrics every run has (the JAX evaluators' key set)
PANOPTIC_KEYS = ["PQ", "SQ", "RQ", "PQ_th", "SQ_th", "RQ_th", "PQ_st",
                 "SQ_st", "RQ_st"]
DEPTH_KEYS = ["Abs Rel", "Sq Rel", "RMSE", "RMSE log", "δ < 1.25",
              "δ < 1.25²", "δ < 1.25³"]


def _eval_opts(cfg, out):
    """Both packages' configs: narrow widths, f32, 64x128 test size, a
    test batch of 2, instances on, two mapping threads, and no DGC: random
    heads predict no road, so the DGC ground would be empty and every depth
    0; without DGC the evaluator scales the network's depth by the GT
    median (DGC is held to JAX in test_torch_evaluation.py)."""
    _configure(cfg)
    cfg.MODEL.POST_PROCESSING.USE_DGC_SCALING = False
    cfg.INPUT.MIN_SIZE_TEST = 64
    cfg.INPUT.MAX_SIZE_TEST = 128
    cfg.TEST.IMS_PER_BATCH = 2
    cfg.TEST.EVAL_INSTANCE = True
    cfg.MODEL.POST_PROCESSING.MAX_INSTANCES = 16
    cfg.DATALOADER.NUM_WORKERS = 2
    cfg.OUTPUT_DIR = str(out)
    return cfg


def _register(root):
    tdata.DatasetCatalog.clear()
    tdata.MetadataCatalog.clear()
    tdata.register_all_cityscapes_scene_seg(str(root))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaltree")
    tdata.write_cityscapes_tree(str(root), 4, 64, 128, seed=5,
                                val_sizes=VAL_SIZES)
    return root


@pytest.fixture(scope="module")
def parity(tree):
    """The JAX and the port's evaluate_dataset on one model and tree (the
    JAX side with its native image library off, so that it never builds
    native/build/), and the pieces the other tests reuse."""
    jcfg = _eval_opts(jax_config(), tree / "jax")
    jcfg.MESH.DATA = 1
    jmodel = j_build_model(jcfg)
    init = jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(0), x,
                                         train=False))
    variables = randomized(init(jnp.zeros((1, 64, 128, 3))), 3)
    cfg = _eval_opts(get_default_config(), tree / "torch")
    model = build_model(cfg, device="cpu")
    model.load_state_dict(load_jax_params(
        {**flatten_params(variables["params"]),
         **flatten_params(variables["batch_stats"])}, model))

    for k in list(jcatalog.DatasetCatalog.list()):
        jcatalog.DatasetCatalog.remove(k)
    jcatalog.MetadataCatalog.clear()
    j_register(str(tree))
    saved = jnative._LIB, jnative._TRIED
    jnative._LIB, jnative._TRIED = None, True
    pans = {"jax": [], "torch": []}

    def keep(cls, out):
        """Make ``cls.process`` keep each predicted panoptic map."""
        process = cls.process

        def keeping(self, pred, *args, **kwargs):
            out.append(np.array(pred))
            return process(self, pred, *args, **kwargs)

        cls.process = keeping
        return process

    import mgnet_tpu.evaluation.panoptic as jpan
    import mgnet_tpu_torch.evaluation.panoptic as tpan

    originals = (keep(jpan.PanopticEvaluator, pans["jax"]),
                 keep(tpan.PanopticEvaluator, pans["torch"]))
    try:
        host = jax.tree_util.tree_map(np.asarray, variables)
        want = j_evaluate_dataset(jcfg, jmodel, {"model": host["params"]},
                                  host["batch_stats"])
        _register(tree)
        got = evaluate_dataset(cfg, model)
    finally:
        jpan.PanopticEvaluator.process, tpan.PanopticEvaluator.process = \
            originals
        jnative._LIB, jnative._TRIED = saved
    return dict(cfg=cfg, model=model, jmodel=jmodel, variables=variables,
                got=got, want=want, pans=pans)


def test_keys_and_panoptic_maps_agree(parity):
    got, want = parity["got"], parity["want"]
    assert list(got) == list(want) == ["panoptic_seg", "sem_seg", "depth",
                                       "instances", "eval_speed"]
    for group in got:
        assert list(got[group]) == list(want[group]), group
    assert list(got["panoptic_seg"]) == PANOPTIC_KEYS
    assert list(got["depth"])[:7] == DEPTH_KEYS
    assert got["eval_speed"]["num_images"] == len(VAL_SIZES)
    pans = parity["pans"]
    assert len(pans["torch"]) == len(pans["jax"]) == len(VAL_SIZES)
    for g, w, (h, wd) in zip(pans["torch"], pans["jax"], VAL_SIZES):
        assert g.shape == w.shape == (h, wd)
        assert (g == w).mean() >= AGREE


@pytest.mark.parametrize("group", ["panoptic_seg", "sem_seg", "depth",
                                   "instances"])
def test_metrics_match_jax(parity, group):
    got, want = parity["got"][group], parity["want"][group]
    assert got.keys() == want.keys()
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{group}/{k}")


def test_multi_scale_flip_inference_matches_jax(parity):
    """Default scales and the flip, at 32x64; semantic probabilities,
    center, offset and depth within 1e-4."""
    rng = np.random.RandomState(4)
    image = rng.randint(0, 256, (2, 32, 64, 3)).astype(np.float32)
    cfg = parity["cfg"]
    pm, ps = cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD
    with torch.no_grad():
        got = multi_scale_flip_inference(
            parity["model"], normalize_images(torch.from_numpy(image), pm,
                                              ps))
    v = parity["variables"]
    jmodel = parity["jmodel"]
    want = jax.jit(lambda v, x: j_multi_scale_flip_inference(jmodel, v, x))(
        {"params": v["params"], "batch_stats": v["batch_stats"]},
        j_normalize(jnp.asarray(image), tuple(pm), tuple(ps)))
    assert set(got) == set(want) == {"sem_seg", "center", "offset", "depth"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_pad_images_do_not_contaminate_metrics(parity, tmp_path):
    """Three val images of one size at batch 4 (the tail pads 3 -> 4)
    against batch 1: the evaluators see 3 samples and the metrics agree
    within 1e-5 relative. The CPU convolutions round differently at
    another batch size (1e-6 relative on a depth metric); a pad copy
    reaching an evaluator would move a mean by a whole sample's share."""
    tdata.write_cityscapes_tree(str(tmp_path), 0, 64, 128, seed=8,
                                val_sizes=[(64, 128)] * 3)
    _register(tmp_path)
    cfg = parity["cfg"].clone()
    results = {}
    for bs in (1, 4):
        cfg.TEST.IMS_PER_BATCH = bs
        results[bs] = evaluate_dataset(cfg, parity["model"])
        assert results[bs]["instances"]["num_images"] == 3
    for section in results[1]:
        if section == "eval_speed":  # wall-clock, not a quality metric
            continue
        for metric, v1 in results[1][section].items():
            np.testing.assert_allclose(v1, results[4][section][metric],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{section}/{metric}")


def test_tta_evaluation_runs(parity, tree):
    """TEST.MSC_FLIP_EVAL on a panoptic-only model: the panoptic and
    semantic metrics, finite."""
    cfg = parity["cfg"].clone()
    cfg.WITH_DEPTH = False
    cfg.TEST.MSC_FLIP_EVAL = True
    cfg.TEST.TTA_IMS_PER_BATCH = 2
    cfg.TEST.EVAL_INSTANCE = False
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    _register(tree)
    res = evaluate_dataset(cfg, model, max_samples=2)
    assert list(res) == ["panoptic_seg", "sem_seg", "eval_speed"]
    assert all(np.isfinite(v) for d in res.values() for v in d.values())


def _mini_opts(out, **extra):
    opts = {"MODEL.GCM.GCM_CHANNELS": 32, "MODEL.COMPUTE_DTYPE": "float32",
            "MODEL.SEM_SEG_HEAD.OHEM_N_MIN": 500, "MODEL.WEIGHTS": "",
            "SOLVER.IMS_PER_BATCH": 2, "SOLVER.MAX_ITER": 2,
            "SOLVER.WARMUP_ITERS": 2, "OUTPUT_DIR": str(out),
            "WRITE_OUTPUT_TO_SUBDIR": False, "DATALOADER.NUM_WORKERS": 2,
            "INPUT.MIN_SIZE_TRAIN": "(64,)", "INPUT.MAX_SIZE_TRAIN": 128,
            "INPUT.CROP.SIZE": "(64, 64)", "INPUT.MIN_SIZE_TEST": 64,
            "INPUT.MAX_SIZE_TEST": 128, "TEST.IMS_PER_BATCH": 2,
            "MODEL.POST_PROCESSING.MAX_INSTANCES": 16}
    for head in ("SEM_SEG_HEAD", "INS_EMBED_HEAD", "DEPTH_HEAD"):
        opts.update({f"MODEL.{head}.HEAD_CHANNELS": 32,
                     f"MODEL.{head}.FFM_CHANNELS": 48,
                     f"MODEL.{head}.ARM_CHANNELS": [32, 32],
                     f"MODEL.{head}.REFINE_CHANNELS": [32, 32]})
    opts.update(extra)
    return [str(x) for kv in opts.items() for x in kv]


def _metric_lines(out):
    with open(out / "metrics.json") as f:
        return [json.loads(line) for line in f]


def test_trainer_evaluates_every_eval_period(tree, tmp_path):
    """TEST.EVAL_PERIOD 2 over 2 iterations: Trainer.test runs once after
    the second step, its metrics go to metrics.json under eval/, and its
    seconds are kept apart from the iteration's others."""
    _register(tree)
    trainer = train_net.main(["--config-file", FINE, "--data-root",
                              str(tree), "--device", "cpu", *_mini_opts(
                                  tmp_path, **{"TEST.EVAL_PERIOD": 2})])
    assert trainer.state.step == 2
    assert trainer.eval_seconds[0] == 0 and trainer.eval_seconds[1] > 0
    lines = [r for r in _metric_lines(tmp_path)
             if any(k.startswith("eval/") for k in r)]
    assert len(lines) == 1 and lines[0]["iteration"] == 2
    keys = {k for k in lines[0] if k.startswith("eval/")}
    assert {f"eval/panoptic_seg/{k}" for k in PANOPTIC_KEYS} <= keys
    assert {f"eval/depth/{k}" for k in DEPTH_KEYS} <= keys
    assert "eval/sem_seg/mIoU" in keys and "eval/eval_speed/images_per_s" \
        in keys


def test_eval_only_loads_model_final_and_writes_metrics(tree, tmp_path):
    """--eval-only with a model_final directory: every entry of the eval
    model comes from it (the training model's pose net and extra depth
    heads are left out), the results are printed and appended to
    metrics.json; a directory without the model's entries, or no weights,
    raises."""
    argv = ["--config-file", FINE, "--data-root", str(tree), "--device",
            "cpu", "--eval-only"]
    cfg = train_net.setup(train_net.parse_args(
        argv + _mini_opts(tmp_path / "cfg")))
    model = build_model(cfg, device="cpu", for_training=True)
    init_random_(model, torch.Generator().manual_seed(123))
    state = create_train_state(cfg, model)
    save_params(str(tmp_path / "model_final"), state.params)

    loaded = build_model(cfg, device="cpu")
    train_net.load_eval_weights(loaded, str(tmp_path / "model_final"))
    src = state.params.model.state_dict()
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, src[k]), k

    _register(tree)
    out = tmp_path / "out"
    res = train_net.main(argv + _mini_opts(out, **{
        "MODEL.WEIGHTS": str(tmp_path / "model_final")}))
    lines = _metric_lines(out)
    assert lines == [json.loads(json.dumps(res))]
    assert list(res) == ["panoptic_seg", "sem_seg", "depth", "eval_speed"]
    assert all(np.isfinite(v) for d in res.values() for v in d.values())

    save_params(str(tmp_path / "other"), torch.nn.Linear(3, 2))
    with pytest.raises(ValueError, match="lacks"):
        train_net.load_eval_weights(loaded, str(tmp_path / "other"))
    with pytest.raises(ValueError, match="needs MODEL.WEIGHTS"):
        train_net.load_eval_weights(loaded, "")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gather_gives_the_one_process_dict(tree):
    """Two gloo processes, each evaluating its strided half of the tree
    with the same seeded model, merge through the evaluators' gathers into
    the one-process dict. Sums merge in another order: 1e-12 relative. As
    in the JAX function, the instance and image counts stay each process's
    own."""
    port = _free_port()
    worker = HERE / "_torch_mp_eval_worker.py"
    env = dict(os.environ, PYTHONPATH=str(HERE.parent))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(rank), str(port), str(tree)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in (0, 1)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    results = [json.loads(next(line for line in out.splitlines()
                               if line.startswith("RESULT "))[7:])
               for out in outs]

    sys.path.insert(0, str(HERE))
    import _torch_mp_eval_worker as w

    _register(tree)
    want = json.loads(json.dumps(w.evaluate(str(tree))))
    del want["instances"]["num_images"], want["instances"]["num_instances"]
    for got in results:
        for group in ("eval_speed", "instances"):
            assert got[group].pop("num_images") == len(VAL_SIZES) // 2
        del got["eval_speed"], got["instances"]["num_instances"]
        assert list(got) == [k for k in want if k != "eval_speed"]
        for group in got:
            assert got[group].keys() == want[group].keys(), group
            for k, v in got[group].items():
                np.testing.assert_allclose(v, want[group][k], rtol=1e-12,
                                           err_msg=f"{group}/{k}")
