"""The port's evaluation pieces against the JAX package's, on the CPU.

Each evaluator of ``mgnet_tpu_torch.evaluation`` is numpy, as its JAX
twin is, so both get the same seeded scenes and their result dicts must be
equal (keys in order, values exactly). The same holds for
``extract_instances``, the eval loop's ``eval_pad_to`` and
``run_bucketed_eval`` (the cases of tests/test_eval_buckets.py), the
visualizer (its resize against OpenCV) and the geometry and loss helpers.
``depth_postprocess`` runs in float32 on both sides: stated bar 1e-5
relative (1e-5 absolute below 1).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgnet_tpu.evaluation as jev
from mgnet_tpu.data.catalog import Metadata as JMetadata
from mgnet_tpu.data.categories import (
    CITYSCAPES_SCENE_SEG_CATEGORIES as JCATS,
    build_meta as j_build_meta,
)
from mgnet_tpu.evaluation.instance_ap import (
    InstanceAPEvaluator as JInstanceAP,
    mask_iou as j_mask_iou,
)
from mgnet_tpu.geometry import (
    calc_smoothness as j_calc_smoothness,
    construct_K as j_construct_K,
    gradient_x as j_gradient_x,
    gradient_y as j_gradient_y,
    match_scales as j_match_scales,
)
from mgnet_tpu.inference.visualizer import Visualizer as JVisualizer
from mgnet_tpu.losses import ssim as j_ssim
from mgnet_tpu.postprocessing import (
    depth_postprocess as j_depth_postprocess,
    extract_instances as j_extract_instances,
)
from mgnet_tpu.train.trainer import (
    eval_pad_to as j_eval_pad_to,
    run_bucketed_eval as j_run_bucketed_eval,
)

import mgnet_tpu_torch.evaluation as tev
from mgnet_tpu_torch.data import (
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    Metadata,
    build_meta,
    read_png,
    write_png,
)
from mgnet_tpu_torch.evaluation.instance_ap import InstanceAPEvaluator, mask_iou
from mgnet_tpu_torch.geometry import (
    calc_smoothness,
    construct_K,
    gradient_x,
    gradient_y,
    match_scales,
)
from mgnet_tpu_torch.inference.visualizer import Visualizer, resize_linear_u8
from mgnet_tpu_torch.losses import ssim
from mgnet_tpu_torch.parallel import (
    all_gather_host,
    all_gather_objects,
    is_main_process,
    process_count,
    process_index,
    synchronize,
)
from mgnet_tpu_torch.postprocessing import depth_postprocess, extract_instances
from mgnet_tpu_torch.train.trainer import eval_pad_to, run_bucketed_eval

H, W = 48, 64
SEEDS = (0, 1, 2)
STUFF = list(range(1, 12))   # road .. sky in the 20-class table
THINGS = list(range(12, 20))  # person .. bicycle
EGO_ID = 999                 # a raw GT id of the ego vehicle (trainId 0)


def _metas():
    return (Metadata(name="t").set(**build_meta(
                CITYSCAPES_SCENE_SEG_CATEGORIES)),
            JMetadata(name="t").set(**j_build_meta(JCATS)))


def _scene(rng):
    """One seeded scene: raw GT ids with their segments (stuff bands, thing
    boxes with a crowd one, the ego vehicle, void) and a panoptic prediction
    in train-id encoding that gets much of it right."""
    gt = np.zeros((H, W), np.int64)
    segs = []
    edges = np.sort(rng.choice(np.arange(4, W - 4), 2, replace=False))
    for x0, x1, cls in zip((0, *edges), (*edges, W), rng.choice(STUFF, 3)):
        gt[:, x0:x1] = cls * 1000
    for cls in np.unique(gt // 1000):
        segs.append({"id": int(cls) * 1000, "category_id": int(cls),
                     "iscrowd": 0})
    for k in range(1, 6):
        cls = int(rng.choice(THINGS))
        h, w = rng.integers(4, 16, 2)
        y, x = rng.integers(0, H - h), rng.integers(0, W - w)
        crowd = int(k == 5)
        gid = cls * 1000 + (50 if crowd else k)
        gt[y:y + h, x:x + w] = gid
        segs.append({"id": gid, "category_id": cls, "iscrowd": crowd})
    gt[-4:] = EGO_ID
    segs.append({"id": EGO_ID, "category_id": 0, "iscrowd": 0})
    gt[:3, :5] = 0  # void
    present = set(np.unique(gt).tolist())
    segs = [s for s in segs if s["id"] in present]

    pred = np.where(gt == EGO_ID, 0, gt)
    pred = np.where(pred == 0, -1, pred)
    pred = np.where(pred % 1000 == 50, pred - 49, pred)  # crowd as one thing
    shift = rng.integers(-2, 3, 2)
    pred = np.roll(pred, shift, axis=(0, 1))
    flip = rng.random((H, W)) < 0.05
    pred[flip] = rng.choice(STUFF, int(flip.sum())) * 1000
    y, x = rng.integers(0, H - 6), rng.integers(0, W - 6)
    pred[y:y + 6, x:x + 6] = -1
    return gt, segs, pred.astype(np.int32)


def _same(got, want):
    """Equal result dicts: the same keys in the same order, equal values
    (NaN equal to NaN)."""
    assert list(got) == list(want)
    for k in got:
        if isinstance(got[k], dict):
            assert list(got[k]) == list(want[k]), k
    np.testing.assert_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_panoptic_evaluator_matches_jax(seed):
    meta, jmeta = _metas()
    ev, jv = tev.PanopticEvaluator(meta), jev.PanopticEvaluator(jmeta)
    rng = np.random.default_rng(seed)
    for i in range(3):
        gt, segs, pred = _scene(rng)
        # one image in train-id encoding on the GT side too
        gt_arg, segs_arg = ((pred.copy(), None) if i == 2 else (gt, segs))
        ev.process(pred, gt_arg, segs_arg)
        jv.process(pred, gt_arg, segs_arg)
    _same(ev.evaluate(print_table=False), jv.evaluate(print_table=False))
    assert ev.format_table() == jv.format_table()


@pytest.mark.parametrize("seed", SEEDS)
def test_semantic_evaluator_matches_jax(seed):
    meta, jmeta = _metas()
    ev, jv = tev.SemSegEvaluator(meta), jev.SemSegEvaluator(jmeta)
    rng = np.random.default_rng(seed)
    for _ in range(3):
        gt, segs, pan = _scene(rng)
        gt_sem = np.full(gt.shape, 255, np.int32)
        for s in segs:
            gt_sem[gt == s["id"]] = s["category_id"]
        pred = np.where(pan >= 0, pan // 1000,
                        rng.integers(0, 20, gt.shape)).astype(np.int32)
        inst = [dict(category_id=s["category_id"], mask=gt == s["id"])
                for s in segs if s["category_id"] in THINGS
                and not s["iscrowd"]]
        ev.process(pred, gt_sem, gt_instances=inst)
        jv.process(pred, gt_sem, gt_instances=inst)
    _same(ev.evaluate(), jv.evaluate())


def _instances(rng, gt, segs, pan):
    preds = []
    for pid in np.unique(pan):
        if pid >= 0 and pid // 1000 in THINGS:
            preds.append(dict(pred_class=int(pid // 1000),
                              score=float(rng.random()), mask=pan == pid))
    gts = [dict(category_id=s["category_id"], mask=gt == s["id"],
                iscrowd=s["iscrowd"])
           for s in segs if s["category_id"] in THINGS]
    return preds, gts


@pytest.mark.parametrize("seed", SEEDS)
def test_instance_ap_evaluator_matches_jax(seed):
    meta, jmeta = _metas()
    ev = InstanceAPEvaluator(meta, min_region_size=40)
    jv = JInstanceAP(jmeta, min_region_size=40)
    rng = np.random.default_rng(seed)
    for _ in range(4):
        gt, segs, pan = _scene(rng)
        preds, gts = _instances(rng, gt, segs, pan)
        ev.process(preds, gts, void_mask=gt == 0)
        jv.process(preds, gts, void_mask=gt == 0)
        a, b = preds[0]["mask"], gts[0]["mask"]
        assert mask_iou(a, b) == j_mask_iou(a, b)
    _same(ev.evaluate(), jv.evaluate())


def _depth_meta(tmp_path, rng, kind):
    if kind == "depth":
        v = (rng.uniform(2, 90, (H, W)) * 256).astype(np.uint16)
        v[:4] = 0
        path = str(tmp_path / "depth.png")
        write_png(path, v)
        return {"depth_file_name": path}
    v = rng.integers(200, 30000, (H, W)).astype(np.uint16)
    v[:4] = 0
    path = str(tmp_path / "disparity.png")
    write_png(path, v)
    return {"disparity_file_name": path, "calibration_info": {
        "intrinsic": {"fx": 226.0}, "extrinsic": {"baseline": 0.222}}}


@pytest.mark.parametrize("kind,gt_scale,eigen", [
    ("depth", False, True), ("depth", True, False),
    ("disparity", False, False), ("disparity", True, True)])
def test_depth_evaluator_matches_jax(tmp_path, kind, gt_scale, eigen):
    """The GT PNG read by read_png on one side and Pillow on the other."""
    ev = tev.DepthEvaluator(use_gt_scale=gt_scale, use_eigen_crop=eigen)
    jv = jev.DepthEvaluator(use_gt_scale=gt_scale, use_eigen_crop=eigen)
    rng = np.random.default_rng(7)
    for i in range(3):
        os.makedirs(tmp_path / str(i))
        meta = _depth_meta(tmp_path / str(i), rng, kind)
        label = tev.read_depth_gt(meta)
        np.testing.assert_array_equal(label, jev.depth.read_depth_gt(meta))
        pred = (label * rng.uniform(0.7, 1.4, label.shape)).astype(
            np.float32) + 0.5
        ev.process(pred, meta)
        jv.process(pred, meta)
    _same(ev.evaluate(), jv.evaluate())
    assert tev.depth_metrics(pred, label + 1) == jev.depth_metrics(
        pred, label + 1)


@pytest.mark.parametrize("seed", (0, 1))
def test_extract_instances_matches_jax(seed):
    rng = np.random.default_rng(seed)
    _, _, pan = _scene(rng)
    logits = rng.normal(size=(H, W, 20)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    center = rng.random((H, W)).astype(np.float32)
    got = extract_instances(probs, center, pan, THINGS)
    want = j_extract_instances(probs, center, pan, THINGS)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(g.pop("mask"), w.pop("mask"))
        assert g == w


def test_single_process_helpers():
    assert (process_count(), process_index(), is_main_process()) == (
        1, 0, True)
    synchronize()
    obj = {"a": np.arange(3)}
    assert all_gather_objects(obj) == [obj]
    assert all_gather_host(obj) is obj


def _depth_inputs(seed=3, b=2, h=24, w=40):
    rng = np.random.default_rng(seed)
    gy = np.linspace(0.5, 1.0, h, dtype=np.float32)[None, :, None, None]
    depth = (4.0 / gy * rng.uniform(0.95, 1.05, (b, h, w, 1))).astype(
        np.float32)
    K = np.stack([np.array([[30.0 + i, 0, w / 2], [0, 31.0, h / 2],
                            [0, 0, 1]], np.float32) for i in range(b)])
    cam_h = np.array([1.22, 1.5], np.float32)[:b]
    pan = np.where(np.arange(h)[:, None] > h // 2, 1000, 11000)
    pan = np.broadcast_to(pan, (b, h, w)).astype(np.int32).copy()
    pan[:, :4, :6] = 0  # ego vehicle
    return depth, K, cam_h, pan


@pytest.mark.parametrize("dgc,road", [(True, 1000), (True, -1),
                                      (False, 1000)])
def test_depth_postprocess_matches_jax(dgc, road):
    """DGC from the road class, DGC from the normals, no DGC; the filtered
    ids (sky 11000, ego 0) give 0 depth and NaN points."""
    depth, K, cam_h, pan = _depth_inputs()
    kw = dict(use_dgc_scaling=dgc, road_class_id=road,
              filter_class_ids=(0, 11000))
    got_d, got_p = depth_postprocess(torch.from_numpy(depth),
                                     torch.from_numpy(K),
                                     torch.from_numpy(cam_h),
                                     torch.from_numpy(pan), **kw)
    want_d, want_p = j_depth_postprocess(jnp.asarray(depth), jnp.asarray(K),
                                         jnp.asarray(cam_h),
                                         jnp.asarray(pan), **kw)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=1e-5, atol=1e-5)
    assert (got_d.numpy()[pan == 0] == 0).all()
    if dgc:
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                                   rtol=1e-5, atol=1e-5)
        assert np.isnan(got_p.numpy()[pan == 11000]).all()
    else:
        assert got_p is None and want_p is None


@pytest.mark.parametrize("n,bs,final,expect", [
    (1, 8, True, 1),
    (2, 8, True, 2),
    (3, 8, True, 4),
    (5, 8, True, 8),
    (7, 8, True, 8),
    (5, 6, True, 6),
    (3, 6, True, 4),
    (7, 12, True, 8),
    (9, 12, True, 12),
    (4, 8, False, 8),
    (8, 8, False, 8),
])
def test_eval_pad_to(n, bs, final, expect):
    assert eval_pad_to(n, bs, final) == expect == j_eval_pad_to(n, bs, final)


def test_eval_pad_to_never_exceeds_batch_size():
    for bs in (1, 2, 3, 4, 6, 8, 12):
        for n in range(1, bs + 1):
            for final in (False, True):
                p = eval_pad_to(n, bs, final)
                assert n <= p <= bs, (n, bs, final, p)
                assert p == j_eval_pad_to(n, bs, final)


@pytest.mark.parametrize("sizes,batch_size", [
    ({"a": 1}, 4),
    ({"a": 5}, 4),
    ({"a": 8}, 4),
    ({"a": 13}, 6),
    ({"a": 3, "b": 5}, 4),
    ({"a": 7, "b": 2, "c": 9}, 3),
    ({"a": 1, "b": 1, "c": 1}, 8),
])
def test_every_item_flushed_exactly_once(sizes, batch_size):
    """Keys interleaved round-robin; every item flushed once, full batches
    mid-stream, at most one final (partial) flush per key and it comes
    last; the JAX scheduler flushes the same sequence."""
    stream, remaining, i = [], dict(sizes), 0
    while remaining:
        for k in sorted(remaining):
            stream.append((k, f"{k}{i}"))
            remaining[k] -= 1
            if remaining[k] == 0:
                del remaining[k]
        i += 1

    def recorder():
        flushed = []

        def flush(key, items, final=False):
            flushed.append((key, list(items), final))
            assert (0 < len(items) < max(batch_size, 2)) if final \
                else len(items) == batch_size
        return flushed, flush

    flushed, flush = recorder()
    n = run_bucketed_eval(iter(stream), lambda it: it[0], batch_size, flush)
    j_flushed, j_flush = recorder()
    assert n == j_run_bucketed_eval(iter(stream), lambda it: it[0],
                                    batch_size, j_flush) == len(stream)
    assert flushed == j_flushed
    assert sorted(it for _, items, _ in flushed for it in items) == \
        sorted(stream)
    for k in sizes:
        mine = [(items, final) for kk, items, final in flushed if kk == k]
        finals = [f for _, f in mine if f]
        assert len(finals) == (1 if sizes[k] % batch_size else 0)
        if finals:
            assert mine[-1][1] and len(mine[-1][0]) == sizes[k] % batch_size


@pytest.mark.parametrize("shape,out", [
    ((64, 128, 3), (100, 200)), ((100, 200, 3), (64, 128)),
    ((37, 53), (80, 90)), ((65, 129, 3), (32, 64)),
    ((100, 200, 3), (50, 100))])
def test_resize_linear_u8_matches_opencv(shape, out):
    import cv2

    img = np.random.default_rng(5).integers(0, 256, shape).astype(np.uint8)
    want = cv2.resize(img, (out[1], out[0]), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(resize_linear_u8(img, *out), want)


def test_visualizer_matches_jax(tmp_path):
    """The panoptic overlay (with an image of another size, resized), the
    offset heatmap and the depth colours equal the JAX visualizer's; the
    saved PNG reads back as written."""
    meta, jmeta = _metas()
    vis, jvis = Visualizer(meta), JVisualizer(jmeta)
    rng = np.random.default_rng(9)
    _, _, pan = _scene(rng)
    image = rng.integers(0, 256, (H + 11, W - 7, 3)).astype(np.uint8)
    got = vis.panoptic_rgb(pan, image)
    np.testing.assert_array_equal(got, jvis.panoptic_rgb(pan, image))
    center = rng.random((H, W)).astype(np.float32)
    offset = rng.normal(size=(H, W, 2)).astype(np.float32)
    np.testing.assert_array_equal(vis.instance_heatmap_rgb(center, offset),
                                  jvis.instance_heatmap_rgb(center, offset))
    depth = rng.uniform(0, 100, (H, W)).astype(np.float32)
    np.testing.assert_array_equal(vis.depth_rgb(depth),
                                  jvis.depth_rgb(depth))
    vis.save_panoptic(str(tmp_path / "p.png"), image, pan)
    np.testing.assert_array_equal(read_png(str(tmp_path / "p.png")), got)


def test_construct_K_matches_jax():
    np.testing.assert_array_equal(construct_K(700.0, 710.5, 319.5, 239.5),
                                  j_construct_K(700.0, 710.5, 319.5, 239.5))


def _image(seed=4, shape=(2, 12, 20, 3)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("name", ["gradient_x", "gradient_y"])
def test_image_gradients_match_jax(name):
    x = _image()
    fn, jfn = {"gradient_x": (gradient_x, j_gradient_x),
               "gradient_y": (gradient_y, j_gradient_y)}[name]
    np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(),
                                  np.asarray(jfn(jnp.asarray(x))))


def test_match_scales_matches_jax():
    x = _image()
    shapes = [(12, 20), (6, 10), (25, 33)]
    for got, want in zip(match_scales(torch.from_numpy(x), shapes),
                         j_match_scales(jnp.asarray(x), shapes)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_calc_smoothness_matches_jax():
    image = _image()
    inv = [_image(s, (2, 12, 20, 1)) + 0.1 for s in (1, 2, 3)]
    got = calc_smoothness([torch.from_numpy(d) for d in inv],
                          torch.from_numpy(image), 3)
    want = j_calc_smoothness([jnp.asarray(d) for d in inv],
                             jnp.asarray(image), 3)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) == 3
        for g, w in zip(g_list, w_list):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-6)


def test_ssim_matches_jax():
    x, y = _image(1), _image(2)
    got = ssim(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(jax.jit(j_ssim)(jnp.asarray(x), jnp.asarray(y)))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
