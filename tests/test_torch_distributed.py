"""The port's data-parallel training (mgnet_tpu_torch/parallel) on the CPU:
two gloo ranks, each on its part of a global batch, compute what one
process computes on the whole of it, as the JAX package's SPMD step does.

One module fixture starts the two ranks of ``_torch_mp_train_worker.py``
once (every case below runs in them) and, meanwhile, compiles the JAX
step sharded over a 2-device mesh of the conftest's CPU devices and runs
the one-process references. Cases: every loss reduction, cross-replica
ABN, the training step (plain at one sample per rank; with
GRAD_ACCUM_STEPS 2 and MODEL.REMAT at two), the loader's per-process
slices, rank-0-only checkpoints and their resume, and train_net with
``--num-devices 2``; then the losses, ABN and the plain step again with
the two ranks as copies of one data shard (MESH.DATA 1 x MESH.MODEL 2),
held to the one process at the same bars.

Bars. (i) Two ranks against the port's one rank: only the float order
differs. Losses agree to 1e-5 relative; gradients by per-leaf cosine
distance to a median of 1e-6 and a worst of 2e-3 (test_torch_train_step.py's
worst-leaf bar: at batch 2 the pooled [B, C, 1, 1] BN sites normalise over
two values, which amplifies f32 rounding), and the global gradient norm
to 2e-3 relative; each BN running statistic to 2e-4 of its tensor's
largest magnitude (the running means are 0.01 x batch means near 0, whose
rounding the same pooled sites amplify). Measured on this fixture, plain
and with accumulation + REMAT: losses 1.3e-7 and 9.5e-7; gradient
cosine distance worst 1.4e-7 and 3.6e-5, median 2.7e-10 and 1.6e-8; the
gradient norm 5.3e-4 and 5.8e-4; running statistics 2.5e-5 and 7.7e-6.
A rank reducing over its own slice misses these by far
(test_local_reductions_miss_the_bar).
(ii) Two ranks against the sharded JAX step: that file's bars.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import _torch_mp_train_worker as w  # noqa: E402
from test_torch_train_step import (  # noqa: E402
    GRAD_COS_DIST,
    GRAD_COS_DIST_MEDIAN,
    LOSS_RTOL,
    _capture_grads,
    _jax_cfg,
    _randomized,
)
from test_torch_trainer import _argv  # noqa: E402

from mgnet_tpu.models.mgnet import build_model as j_build_model  # noqa: E402
from mgnet_tpu.parallel import (  # noqa: E402
    create_mesh,
    replicate_to_mesh,
    shard_batch as j_shard_batch,
)
from mgnet_tpu.train.state import create_train_state  # noqa: E402
from mgnet_tpu.train.step import (  # noqa: E402
    make_train_step as j_make_train_step,
)
from mgnet_tpu.utils.weights import flatten_params  # noqa: E402

import mgnet_tpu_torch.data as tdata  # noqa: E402
from mgnet_tpu_torch.config import get_default_config  # noqa: E402
from mgnet_tpu_torch.models import build_model  # noqa: E402
from mgnet_tpu_torch.parallel import (  # noqa: E402
    all_mean,
    all_sum,
    average_gradients,
    data_parallel_size,
    local_positions,
    reduce_,
    shard_batch,
)
from mgnet_tpu_torch.parallel.multihost import (  # noqa: E402
    data_count,
    data_index,
    model_axis_size,
)
from mgnet_tpu_torch.parallel.collectives import CALLS  # noqa: E402
from mgnet_tpu_torch.train import (  # noqa: E402
    create_train_state as t_create_train_state,
)
from mgnet_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from mgnet_tpu_torch.utils.weights import (  # noqa: E402
    load_jax_params,
    to_jax_arrays,
)

# bar (i): two ranks against one, the float order apart
REL_I = 1e-5
COS_MEDIAN_I = 1e-6
COS_WORST_I = 2e-3
GRAD_NORM_I = 2e-3
STATS_I = 2e-4
CLI_ITERS = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=str(HERE.parent), OMP_NUM_THREADS="1")


def _cli(tree, out, *flags, **opts) -> subprocess.Popen:
    """train_net on two CPU ranks, started."""
    argv = _argv(tree, out, "--num-devices", "2", "--coordinator",
                 f"127.0.0.1:{_free_port()}", *flags,
                 **{"SOLVER.CHECKPOINT_PERIOD": 1, "MODEL.WEIGHTS": "",
                    **opts})
    return subprocess.Popen(
        [sys.executable, "-m", "mgnet_tpu_torch.tools.train_net", *argv],
        env=_env(), cwd=str(HERE.parent), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _ended(p: subprocess.Popen):
    """(return code, output) of a started process."""
    out = p.communicate(timeout=600)[0]
    return p.returncode, out


def _train_then_resume(tree, result: dict) -> None:
    """train_net on the mini tree for CLI_ITERS iterations, then a --resume
    run for one more; each run's (return code, output) and the checkpoint
    steps after it, into ``result``."""
    out = tree / "out"
    for name, flags, iters in (("train", (), CLI_ITERS),
                               ("resume", ("--resume",), CLI_ITERS + 1)):
        result[name] = _ended(_cli(tree, out, *flags,
                                   **{"SOLVER.MAX_ITER": iters}))
        result[name + "_steps"] = CheckpointManager(
            str(out / "checkpoints")).steps()
        if result[name][0]:
            return


def _cos_dists(got, want):
    """Per-leaf gradient cosine distance 1 - cos."""
    dists = {}
    for k, b in want.items():
        a = np.asarray(got[k], np.float64).ravel()
        b = np.asarray(b, np.float64).ravel()
        den = np.linalg.norm(a) * np.linalg.norm(b)
        dists[k] = 0.0 if den == 0 and np.allclose(a, b) else \
            1.0 - float(a @ b) / den
    return dists


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results, the one-process references, the sharded
    JAX step, and the train_net runs (they run meanwhile): on the mini
    tree with its resume, and without a dataset."""
    out = tmp_path_factory.mktemp("distributed")
    tree = out / "tree"
    tdata.write_cityscapes_tree(str(tree), 4, 96, 192, seed=11)
    clis = {}
    cli_thread = threading.Thread(target=_train_then_resume,
                                  args=(tree, clis))
    cli_thread.start()
    no_data = _cli(out / "empty", out / "empty" / "out",
                   **{"SOLVER.MAX_ITER": 1})
    # the variables: flax's, with BN scale and bias redrawn, in the port
    jcfg = _jax_cfg()
    jmodel = j_build_model(jcfg)
    jstate = create_train_state(jcfg, jmodel, jax.random.PRNGKey(0),
                                sample_shape=(1, w.H, w.W, 3),
                                tx=_capture_grads())
    jstate = jstate.replace(params=_randomized(jstate.params, 1))
    variables = {**flatten_params(jstate.params), **{
        "model/" + k: v for k, v in
        flatten_params(jstate.batch_stats).items()}}
    cfg = w.step_config()
    params = t_create_train_state(cfg, build_model(
        cfg, device="cpu", for_training=True)).params
    state_dict = load_jax_params(variables, params)
    torch.save(state_dict, out / "state.pt")

    port = _free_port()
    ranks = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_mp_train_worker.py"), str(r),
         str(port), str(out / "state.pt"), str(out)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(w.WORLD)]
    try:
        # the JAX step with the batch sharded over a (data=2) mesh
        mesh = create_mesh(data=2, model=1)
        batch = w.step_batch(1)
        jstep = jax.jit(j_make_train_step(jcfg, jmodel))
        new_state, metrics = jstep(
            replicate_to_mesh(mesh, jstate),
            j_shard_batch(mesh, {k: jnp.asarray(v)
                                 for k, v in batch.items()}))
        jax_run = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=flatten_params(jax.device_get(new_state.opt_state["g"])),
            stats={"model/" + k: np.asarray(v) for k, v in flatten_params(
                jax.device_get(new_state.batch_stats)).items()})

        # the port's one-process references and the per-rank-local steps
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            ref = {f"loss/{n}": w.loss_case(n, 0, 1) for n in w.LOSS_CASES}
            ref.update({f"abn/{n}": w.abn_case(n, 0, 1)
                        for n in w.ABN_CASES})
            ref.update({k: w.step_case(state_dict, *v, 0, 1)
                        for k, v in w.STEP_CASES.items()})
            for k in (1, 2):
                ref[f"loader/{k}"] = w.loader_batches(0, 1, k)
            # no group here: each rank's slice stepped alone, as a
            # per-rank DDP forward would
            local = [w.step_case(state_dict, 1, False, 1, r, w.WORLD)
                     for r in range(w.WORLD)]
        finally:
            torch.set_num_threads(threads)

        logs = [p.communicate(timeout=600)[0] for p in ranks]
        clis["no_data"] = _ended(no_data)
        cli_thread.join(timeout=900)
    finally:
        for p in ranks + [no_data]:
            if p.poll() is None:
                p.kill()
    for p, log in zip(ranks, logs):
        assert p.returncode == 0, log[-3000:]
    got = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(w.WORLD)]
    return dict(out=out, got=got, ref=ref, jax=jax_run, local=local,
                tree=tree, cli=clis)


def _joined(run, key, field):
    return torch.cat([g[key][field] for g in run["got"]]).numpy()


@pytest.mark.parametrize("case", w.LOSS_CASES)
def test_loss_value_equals_one_process(run, case):
    want = run["ref"][f"loss/{case}"]["value"]
    for g in run["got"]:
        assert g[f"loss/{case}"]["value"] == pytest.approx(want, rel=1e-6,
                                                           abs=1e-7)


@pytest.mark.parametrize("case", w.LOSS_CASES)
def test_loss_input_gradients_equal_one_process(run, case):
    """Each rank's gradients of the global loss, joined in rank order,
    equal the one-process gradients of the whole batch."""
    want = run["ref"][f"loss/{case}"]["grads"]
    assert want and set(run["got"][0][f"loss/{case}"]["grads"]) == set(want)
    for name, v in want.items():
        got = torch.cat([g[f"loss/{case}"]["grads"][name]
                         for g in run["got"]])
        scale = float(v.abs().max())
        np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=name)


@pytest.mark.parametrize("aspect", ["forward", "backward", "running_stats"])
@pytest.mark.parametrize("case", list(w.ABN_CASES))
def test_abn_uses_the_global_batch(run, case, aspect):
    """Cross-replica ABN: outputs and input gradients joined, scale and
    bias gradients summed over the ranks, running statistics on every
    rank, all equal the one-process ABN on the whole batch (the pooled
    sites at one sample per rank included, whose local variance is 0)."""
    key = f"abn/{case}"
    want = run["ref"][key]
    if aspect == "forward":
        pairs = [("out", _joined(run, key, "out"), want["out"])]
    elif aspect == "backward":
        np.testing.assert_allclose(_joined(run, key, "x_grad"),
                                   want["x_grad"], rtol=1e-5,
                                   atol=1e-6 * want["grad_scale"])
        pairs = [(k, sum(g[key][k] for g in run["got"]), want[k])
                 for k in ("weight_grad", "bias_grad")]
    else:
        pairs = [(f"{k} rank {r}", g[key][k], want[k])
                 for r, g in enumerate(run["got"])
                 for k in ("running_mean", "running_var")]
    for name, got, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(ref).max()),
                                   err_msg=name)


def _assert_losses(got, want, rel, keys=None):
    keys = keys or list(want)
    worst = max(keys, key=lambda k: abs(got[k] - want[k]) / abs(want[k]))
    print(f"losses: worst {worst} "
          f"{abs(got[worst] - want[worst]) / abs(want[worst]):.2e}")
    for k in keys:
        assert got[k] == pytest.approx(want[k], rel=rel, abs=1e-7), k


def _assert_grads(got, want, worst_bar, median_bar):
    assert set(got) == set(want)
    dists = _cos_dists(got, want)
    worst = max(dists, key=dists.get)
    median = float(np.median(list(dists.values())))
    print(f"gradient cosine distance: worst {worst} {dists[worst]:.3e}, "
          f"median {median:.3e} over {len(dists)} leaves")
    assert dists[worst] < worst_bar, (worst, dists[worst])
    assert median < median_bar


def _stats_dist(got, want):
    """Per BN statistic, max |got - want| over its largest magnitude."""
    assert set(got) == set(want)
    return {k: float(np.abs(np.asarray(got[k]) - np.asarray(v)).max()
                     / np.abs(np.asarray(v)).max()) for k, v in want.items()}


STEPS = ["plain", "accum_remat"]


@pytest.mark.parametrize("variant", STEPS)
def test_step_losses_equal_one_rank(run, variant):
    want = run["ref"][f"step/{variant}"]["metrics"]
    for g in run["got"]:
        got = g[f"step/{variant}"]["metrics"]
        _assert_losses(got, want, REL_I,
                       keys=[k for k in want if k != "grad_norm"])
        print(f"grad_norm {got['grad_norm']} against {want['grad_norm']}")
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=GRAD_NORM_I)


@pytest.mark.parametrize("variant", STEPS)
def test_step_gradients_equal_one_rank(run, variant):
    _assert_grads(run["got"][0][f"step/{variant}"]["grads"],
                  run["ref"][f"step/{variant}"]["grads"], COS_WORST_I,
                  COS_MEDIAN_I)


@pytest.mark.parametrize("variant", STEPS)
def test_step_running_stats_equal_one_rank(run, variant):
    for g in run["got"]:
        dist = _stats_dist(g[f"step/{variant}"]["stats"],
                           run["ref"][f"step/{variant}"]["stats"])
        worst = max(dist, key=dist.get)
        print(f"running statistics: worst {worst} {dist[worst]:.2e}")
        assert dist[worst] < STATS_I, (worst, dist[worst])


@pytest.mark.parametrize("variant", STEPS)
def test_step_leaves_the_ranks_bitwise_equal(run, variant):
    """Parameters, BN statistics and gradients after the step: the same
    on both ranks, bit for bit."""
    a, b = (g[f"step/{variant}"] for g in run["got"])
    for field in ("params", "grads"):
        assert a[field].keys() == b[field].keys()
        for k in a[field]:
            assert torch.equal(a[field][k], b[field][k]), (field, k)


def test_step_losses_equal_the_sharded_jax_step(run):
    got = run["got"][0]["step/plain"]["metrics"]
    _assert_losses(got, run["jax"]["metrics"], LOSS_RTOL)


def test_step_gradients_equal_the_sharded_jax_step(run):
    got = to_jax_arrays(run["got"][0]["step/plain"]["grads"])
    _assert_grads(got, run["jax"]["grads"], GRAD_COS_DIST,
                  GRAD_COS_DIST_MEDIAN)


def test_step_running_stats_equal_the_sharded_jax_step(run):
    got = to_jax_arrays(run["got"][0]["step/plain"]["stats"])
    assert set(got) == set(run["jax"]["stats"])
    for k, v in run["jax"]["stats"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def test_local_reductions_miss_the_bar(run):
    """What bar (i) guards against: a rank stepping on its slice alone
    (per-rank OHEM over its own pixels, per-rank BN statistics, which at
    one sample per rank give the pooled sites a variance of 0) misses it,
    on loss_sem_seg and on the running statistics."""
    want = run["ref"]["step/plain"]
    for local in run["local"]:
        sem = local["metrics"]["loss_sem_seg_raw"]
        ref = want["metrics"]["loss_sem_seg_raw"]
        worst = max(_stats_dist(local["stats"], want["stats"]).values())
        print(f"a rank alone: loss_sem_seg rel {abs(sem - ref) / ref:.2e}, "
              f"running statistics {worst:.2e}")
        assert abs(sem - ref) > 100 * REL_I * abs(ref), (sem, ref)
        assert worst > 100 * STATS_I, worst


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_loader_slices_join_into_the_global_batches(run, micro_batches):
    """Each rank maps only its part of every global batch; joined in rank
    order (within each micro-batch) they are the one-process batches."""
    want = run["ref"][f"loader/{micro_batches}"]
    got = [g[f"loader/{micro_batches}"] for g in run["got"]]
    assert len(want) == len(got[0]) == len(got[1])
    for i, batch in enumerate(want):
        assert all(len(g[i]["index"]) == 2 for g in got)
        for key, v in batch.items():
            pos = [local_positions(4, r, w.WORLD, micro_batches)
                   for r in range(w.WORLD)]
            joined = np.empty_like(v)
            for r in range(w.WORLD):
                joined[pos[r]] = got[r][i][key]
            np.testing.assert_array_equal(joined, v, err_msg=f"{i} {key}")


def test_checkpoints_and_logs_are_written_by_rank_zero_only(run):
    c0, c1 = (g["checkpoint"] for g in run["got"])
    assert c0["files"] == ["7.pt"] and c1["files"] == []
    assert c0["log_files"] and "metrics.json" in c0["log_files"]
    assert c1["log_files"] == []


def test_resume_by_two_ranks_equals_the_checkpoint(run):
    payload = torch.load(run["out"] / "ckpt_rank0" / "7.pt",
                         weights_only=True)
    for g in run["got"]:
        c = g["checkpoint"]
        assert c["restored"] and c["step"] == 7
        assert c["params"].keys() == payload["params"].keys()
        for k, v in payload["params"].items():
            assert torch.equal(c["params"][k], v), k


def test_train_net_trains_on_two_ranks_and_resumes(run):
    """train_net --device cpu --num-devices 2: two gloo ranks train the
    mini tree (one sample each), rank 0 alone writes the checkpoints, the
    metrics and model_final; a --resume run of both ranks continues."""
    cli, out = run["cli"], run["tree"] / "out"
    rc, log = cli["train"]
    assert rc == 0, log[-4000:]
    assert cli["train_steps"] == [1, 2]
    assert (out / "model_final" / "params.pt").is_file()
    rc, log = cli["resume"]
    assert rc == 0, log[-4000:]
    assert log.count(f"Resumed from step {CLI_ITERS}") == 2, log[-4000:]
    assert cli["resume_steps"] == [1, 2, 3]
    # one metrics line per run (its first iteration), from rank 0 alone
    lines = (out / "metrics.json").read_text().splitlines()
    assert len(lines) == 2, lines
    # every rank writes the same config; MESH.DATA is the world size
    assert "DATA: 2" in (out / "config.yaml").read_text()


def test_train_net_fails_when_a_rank_fails(run):
    """A rank that raises (here: no dataset under --data-root) makes the
    command exit non-zero."""
    rc, log = run["cli"]["no_data"]
    assert rc != 0 and "ProcessRaisedException" in log, log[-4000:]


def test_mesh_model_axis_raises():
    """MESH.MODEL copies data shards over ranks: without a group (one
    rank) a model axis of 2 has no second rank, and raises."""
    cfg = get_default_config()
    cfg.MESH.MODEL = 2
    with pytest.raises(ValueError, match="MESH.MODEL=2"):
        data_parallel_size(cfg)
    assert (model_axis_size(), data_count(), data_index()) == (1, 1, 0)


@pytest.mark.parametrize("case", w.LOSS_CASES)
def test_model_axis_loss_equals_one_process(run, case):
    """DATA 1 x MODEL 2: each rank holds the whole global batch, and its
    loss and input gradients equal the one process's."""
    want = run["ref"][f"loss/{case}"]
    for g in run["got"]:
        got = g[f"model2/loss/{case}"]
        assert got["value"] == pytest.approx(want["value"], rel=1e-6,
                                             abs=1e-7)
        assert set(got["grads"]) == set(want["grads"])
        for name, v in want["grads"].items():
            np.testing.assert_allclose(
                got["grads"][name].numpy(), v.numpy(), rtol=1e-5,
                atol=1e-6 * float(v.abs().max()), err_msg=name)


@pytest.mark.parametrize("case", list(w.ABN_CASES))
def test_model_axis_abn_equals_one_process(run, case):
    """DATA 1 x MODEL 2: ABN's output, gradients and running statistics
    on each rank equal the one process's (the running variance's n/(n-1)
    counts one copy of the batch)."""
    want = run["ref"][f"abn/{case}"]
    for g in run["got"]:
        got = g[f"model2/abn/{case}"]
        for k in ("out", "x_grad", "weight_grad", "bias_grad",
                  "running_mean", "running_var"):
            ref = np.asarray(want[k])
            np.testing.assert_allclose(
                np.asarray(got[k]), ref, rtol=1e-5,
                atol=1e-6 * float(np.abs(ref).max()), err_msg=k)


@pytest.mark.parametrize("aspect", ["losses", "gradients", "running_stats"])
def test_model_axis_step_equals_one_rank(run, aspect):
    """DATA 1 x MODEL 2: the plain training step of each rank (the whole
    batch on both) equals the one rank's at bar (i), and the two ranks
    hold the same parameters bit for bit."""
    want = run["ref"]["model2/step/plain"]
    for g in run["got"]:
        got = g["model2/step/plain"]
        if aspect == "losses":
            _assert_losses(got["metrics"], want["metrics"], REL_I)
        elif aspect == "gradients":
            _assert_grads(got["grads"], want["grads"], COS_WORST_I,
                          COS_MEDIAN_I)
        else:
            dist = _stats_dist(got["stats"], want["stats"])
            assert max(dist.values()) < STATS_I, dist
    a, b = (g["model2/step/plain"] for g in run["got"])
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k


def test_data_parallel_size_holds_mesh_model_to_the_group_axis(run):
    """In a group of two whose model axis is 1, MESH.MODEL 2 raises; once
    the group's axis is 2, DATA is 1 and both ranks hold data shard 0."""
    for g in run["got"]:
        check = g["model_axis_check"]
        assert "the group's model axis is 1" in check["before"], check
        assert check["after"] == (1, 1, 0), check


def test_model_axis_takes_the_hard_pixel_count_on_the_data_axis(run):
    """The top-20% CE over copies: k must be MODEL x int(p n DATA) = 2 x
    204, not int(p n DATA MODEL) = 409, or another set of pixels is
    averaged. On the doubled pixels of the one process the right k gives
    its loss and the other k does not; the ranks give the right one."""
    from mgnet_tpu_torch.losses.segmentation import _per_pixel_ce, topk_sum

    g = w.loss_inputs()
    ce, _ = _per_pixel_ce(torch.from_numpy(g["logits"]),
                          torch.from_numpy(g["labels"]), 255)
    flat = (ce * torch.from_numpy(g["weights"])).reshape(-1)
    n, p = flat.numel(), 0.2
    right, wrong = 2 * int(p * n), int(p * n * 2)
    assert right != wrong
    doubled = torch.cat([flat, flat])
    want = run["ref"]["loss/deeplab_topk"]["value"]
    assert float(topk_sum(doubled, right) / right) == pytest.approx(
        want, rel=1e-6)
    naive = float(topk_sum(doubled, wrong) / wrong)
    assert abs(naive - want) > 1e-5 * want, (naive, want)
    for rank in run["got"]:
        assert rank["model2/loss/deeplab_topk"]["value"] == pytest.approx(
            want, rel=1e-6, abs=1e-7)


def test_mesh_data_must_be_the_world_size():
    cfg = get_default_config()
    assert data_parallel_size(cfg) == 1
    cfg.MESH.DATA = 1
    assert data_parallel_size(cfg) == 1
    cfg.MESH.DATA = 2
    with pytest.raises(ValueError, match="MESH.DATA=2"):
        data_parallel_size(cfg)


def test_collectives_call_nothing_at_world_one():
    """Without a group each collective is the identity (the same tensor,
    no copy) and calls nothing: the one-card step keeps its launches."""
    x = torch.arange(4.0, requires_grad=True)
    before = dict(CALLS)
    assert all_sum(x) is x and all_mean(x) is x
    y = torch.ones(3)
    assert reduce_(y) is y and reduce_(y, "max") is y
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 3.0)
    g = p.grad
    average_gradients([p])
    assert p.grad is g
    assert CALLS == before


def test_shard_batch_takes_each_ranks_share_of_each_micro_batch():
    batch = {"x": torch.arange(8), "n": np.arange(8) * 10, "meta": "a"}
    assert shard_batch(batch, 1, 0, 1) is batch
    assert shard_batch(batch, 1, 1, 2)["x"].tolist() == [4, 5, 6, 7]
    two = shard_batch(batch, 2, 1, 2)
    assert two["x"].tolist() == [2, 3, 6, 7]
    assert two["n"].tolist() == [20, 30, 60, 70] and two["meta"] == "a"
    assert local_positions(12, 2, 3, 2) == [4, 5, 10, 11]
    with pytest.raises(ValueError, match="does not divide"):
        local_positions(6, 0, 2, 2)


def test_train_net_sets_the_data_axis_over_the_model_axis(tmp_path):
    """--num-devices N with MESH.MODEL M: MESH.DATA becomes N / M (M must
    divide N); M 1 keeps DATA the world size."""
    from mgnet_tpu_torch.tools import train_net

    def data_axis(*opts):
        args = train_net.parse_args([
            "--device", "cpu", "--num-devices", "4", "--eval-only",
            "OUTPUT_DIR", str(tmp_path), *opts])
        return train_net.setup(args).MESH.DATA

    assert data_axis() == 4
    assert data_axis("MESH.MODEL", "2") == 2
    with pytest.raises(ValueError, match="MESH.MODEL=3"):
        data_axis("MESH.MODEL", "3")
