"""The port's center_argmin against the JAX package's Pallas kernel.

On the CPU the wrapper runs its plain version; it is held EXACTLY (index
for index) against ``mgnet_tpu.ops.pallas.center_argmin`` in interpret
mode, variant "kloop" (the TPU default), batched, with invalid, duplicate
and out-of-image centers. The kernel itself is compared with the plain
version on the card in tests/test_torch_gpu.py.

The kernel scans, per pixel tile, only the centers that
``center_candidates_reference`` keeps. Here that rule is held, on every
input family of tests/torch_center_cases.py, to what makes the kernel
exact: the plain version's winner and every center tied with it are kept,
and a strict scan over the kept centers in ascending order returns the
plain version's index.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgnet_tpu.ops.pallas.center_argmin import center_argmin as jax_argmin
from mgnet_tpu_torch.ops.center_argmin import (
    TILE_H,
    TILE_W,
    center_argmin,
    center_argmin_reference,
    center_candidates_reference,
    center_inputs,
)
from torch_center_cases import CASES, center_case  # tests/ is on sys.path


def _case(seed, b=3, h=40, w=72, k=16):
    """Pixel targets near the grid, centers with duplicates (exact ties),
    out-of-image centers and invalid slots."""
    rng = np.random.RandomState(seed)
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None]
    py = ys + rng.randn(b, h, w).astype(np.float32) * 6
    px = xs + rng.randn(b, h, w).astype(np.float32) * 6
    centers = rng.uniform(0, [h, w], (b, k, 2)).astype(np.float32)
    if k >= 8:
        centers[:, k // 2: k // 2 + 3] = centers[:, 0:3]    # duplicates
        centers[:, -2] = (-30.0, w + 40.0)                  # outside
    valid = rng.rand(b, k) > 0.25
    valid[:, 0] = True
    return py, px, centers, valid


def _jax(py, px, centers, valid):
    pts = jnp.stack([jnp.asarray(py), jnp.asarray(px)], axis=-1)
    fn = lambda p, c, v: jax_argmin(p, c, v, interpret=True,
                                    variant="kloop")
    return np.asarray(jax.vmap(fn)(pts, jnp.asarray(centers),
                                   jnp.asarray(valid)))


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_jax_kernel_exactly(seed):
    py, px, centers, valid = _case(seed)
    want = _jax(py, px, centers, valid)
    args = (torch.from_numpy(py), torch.from_numpy(px),
            *center_inputs(torch.from_numpy(centers),
                           torch.from_numpy(valid)))
    got = center_argmin_reference(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = center_argmin.launches
    np.testing.assert_array_equal(center_argmin(*args).numpy(), want)
    assert center_argmin.launches == before


def test_ties_go_to_the_lowest_index():
    py = torch.full((1, 2, 3), 5.0)
    px = torch.full((1, 2, 3), 5.0)
    centers = torch.tensor([[[0.0, 0.0], [5.0, 5.0], [5.0, 5.0], [5.0, 5.0]]])
    valid = torch.tensor([[True, False, True, True]])
    out = center_argmin(py, px, *center_inputs(centers, valid))
    assert (out == 2).all()


def test_center_inputs_sentinel_and_clamp():
    centers = torch.tensor([[[1.0, 2.0], [3.0, 4.0]]])
    valid = torch.tensor([[True, False]])
    cy, cx, c2 = center_inputs(centers, valid)
    big = float(np.float32(1e12))
    assert cy.tolist() == [[1.0, big]] and cx.tolist() == [[2.0, big]]
    assert c2[0, 0].item() == 5.0
    assert c2[0, 1].item() == pytest.approx(2e24, rel=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "rank", "centers", "device",
                                 "kept_pairs"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    py, px, centers, valid = _case(0, b=1, h=4, w=5, k=3)
    args = [torch.from_numpy(py), torch.from_numpy(px),
            *center_inputs(torch.from_numpy(centers),
                           torch.from_numpy(valid))]
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "rank":
        args[0] = args[0][0]
    elif bad == "centers":
        args[4] = args[4][:, :2]
    elif bad == "device":
        args[0] = args[0].to("meta")
    with pytest.raises((TypeError, ValueError)):
        if bad == "kept_pairs":
            center_argmin(*args, kept_pairs=torch.zeros(1, dtype=torch.int32))
        else:
            center_argmin(*args)


def _kept_per_pixel(mask, h, w, tile):
    """[B, nTy, nTx, K] tile mask -> [B, H, W, K] mask of each pixel's tile."""
    ty = torch.arange(h) // tile[0]
    tx = torch.arange(w) // tile[1]
    return mask[:, ty[:, None], tx[None, :]]


def _scores(py, px, cy, cx, c2):
    """[B, H, W, K] f32 scores, rounded as the plain version rounds them."""
    def at(c):
        return c[:, None, None, :]
    return at(c2) - 2.0 * (py[..., None] * at(cy) + px[..., None] * at(cx))


def _scan_kept(py, px, cy, cx, c2, kept):
    """The kernel's stage 3: a strict scan from (+inf, 0) over the kept
    centers, ascending (a dropped center's score as NaN never updates)."""
    best = torch.full_like(py, float("inf"))
    besti = torch.zeros(py.shape, dtype=torch.int32)
    for i in range(cy.shape[1]):
        score = c2[:, i, None, None] - 2.0 * (py * cy[:, i, None, None]
                                              + px * cx[:, i, None, None])
        pred = (score < best) & kept[..., i]
        best = torch.where(pred, score, best)
        besti.masked_fill_(pred, i)
    return besti


@pytest.mark.parametrize("tile", [(TILE_H, TILE_W), (8, 32), (8, 128)])
@pytest.mark.parametrize("name", CASES)
def test_candidate_rule_keeps_every_winner_and_tie(name, tile):
    b, h, w, k = 2, 45, 70, 24
    args = center_case(name, b, h, w, k, seed=3)
    want = center_argmin_reference(*args)
    mask = center_candidates_reference(*args, *tile)
    assert mask.shape == (b, -(-h // tile[0]), -(-w // tile[1]), k)
    kept = _kept_per_pixel(mask, h, w, tile)
    scores = _scores(*args)
    best = scores.gather(-1, want.long()[..., None])
    assert kept.gather(-1, want.long()[..., None]).all()
    assert (kept | ~(scores == best)).all()     # every tie is kept
    assert torch.equal(_scan_kept(*args, kept), want)
    finite = (torch.isfinite(args[0]) & torch.isfinite(args[1]))
    if name == "nonfinite":
        assert not finite.all()
    # a tile with a NaN or inf coordinate keeps every center
    assert kept[~finite].all()
    if name == "grid":
        assert not mask.all()


def test_candidate_rule_prunes_the_main_paths_distribution():
    """chip_smoke.py's case A at its own shape: 1024x2048, K=128."""
    args = center_case("grid", 1, 1024, 2048, 128)
    share = float(center_candidates_reference(*args).float().mean())
    assert share < 0.25


def test_kept_pairs_on_the_cpu_count_the_rule():
    args = center_case("grid", 2, 40, 72, 16)
    kept = torch.zeros(1, dtype=torch.int64)
    out = center_argmin(*args, kept_pairs=kept)
    assert torch.equal(out, center_argmin_reference(*args))
    assert int(kept) == int(center_candidates_reference(*args).sum())


def test_tile_matches_the_kernel_source():
    import mgnet_tpu_torch.ops as ops

    src = (Path(ops.__file__).parent / "csrc" / "center_argmin.cu").read_text()
    tile = [int(re.search(rf"#define CENTER_TILE_{d} (\d+)", src).group(1))
            for d in "HW"]
    assert tile == [TILE_H, TILE_W]
