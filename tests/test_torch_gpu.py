"""Hand-written kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips without a CUDA card (the kernels have no
CPU mode). This file imports no JAX, so that it also runs on a machine
without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from mgnet_tpu_torch.ops.center_argmin import (
    center_argmin,
    center_argmin_reference,
    center_candidates_reference,
    center_inputs,
)
from mgnet_tpu_torch.ops.ssim import (
    fused_photometric_residual,
    ssim_residual_bwd,
    ssim_residual_bwd_reference,
    ssim_residual_fwd,
    ssim_residual_reference,
)
from mgnet_tpu_torch.ops.warp import warp_bilinear, warp_bilinear_reference
from torch_center_cases import CASES, center_case, misaligned  # tests/ on path


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _center_case(b, h, w, k, seed=0):
    """Coordinates near the grid; centers with duplicates (exact ties),
    out-of-image ones and invalid slots."""
    g = torch.Generator().manual_seed(seed)
    ys = torch.arange(h, dtype=torch.float32)[:, None]
    xs = torch.arange(w, dtype=torch.float32)[None]
    py = ys + 20 * torch.randn(b, h, w, generator=g)
    px = xs + 20 * torch.randn(b, h, w, generator=g)
    centers = torch.rand(b, k, 2, generator=g) * torch.tensor([h, w])
    if k >= 8:
        centers[:, k // 2: k // 2 + 3] = centers[:, 0:3]
        centers[:, -2] = torch.tensor([-30.0, w + 40.0])
    valid = torch.rand(b, k, generator=g) > 0.25
    valid[:, 0] = True
    return [t.cuda() for t in (py, px, *center_inputs(centers, valid))]


# the frame's shape; small and degenerate planes; KITTI's serving shape
# (configs/MGNet-KITTI-Eigen-Zhou.yaml); one row and one column past the
# 32 x 32 tile, two images; MAX_CENTERS
@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,k", [(1, 1024, 2048, 128), (3, 37, 53, 5),
                                     (2, 8, 12, 1), (1, 384, 1280, 128),
                                     (2, 33, 65, 128), (1, 64, 96, 4096)])
def test_center_argmin_kernel_matches_plain_version(b, h, w, k):
    _need_card()
    args = _center_case(b, h, w, k)
    before = center_argmin.launches
    got = center_argmin(*args)
    torch.cuda.synchronize()
    assert center_argmin.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (b, h, w)
    assert torch.equal(got, center_argmin_reference(*args))


# every input family of tests/torch_center_cases.py (targets scattered
# over the image, all centers invalid, NaN and inf coordinates, 1e20
# coordinates, c2 clamped, near-ties and the bisector of two centers near
# (1000, 2000)), with the planes 16-byte aligned and one element off (the
# scalar path); the scattered and instance-like targets at the frame's shape
@pytest.mark.gpu
@pytest.mark.parametrize("name,shape,aligned", [
    *((n, (2, 70, 136, 64), a) for n in CASES for a in (True, False)),
    ("scattered", (1, 1024, 2048, 128), True),
    ("instance", (1, 1024, 2048, 128), True)])
def test_center_argmin_kernel_on_hard_inputs(name, shape, aligned):
    _need_card()
    args = [t.cuda() for t in center_case(name, *shape, seed=1)]
    if not aligned:
        args = misaligned(args)
        assert args[0].data_ptr() % 16 != 0
    before = center_argmin.launches
    got = center_argmin(*args)
    torch.cuda.synchronize()
    assert center_argmin.launches == before + 1
    assert torch.equal(got, center_argmin_reference(*args))


@pytest.mark.gpu
def test_center_argmin_kept_pairs_match_the_rule():
    """The kernel's own count of scanned (tile, center) pairs equals what
    center_candidates_reference keeps (the same f64 formulas, one rounding
    each, on the CPU) on chip_smoke.py's case-A distribution."""
    _need_card()
    cpu_args = center_case("grid", 1, 256, 512, 128)
    args = [t.cuda() for t in cpu_args]
    kept = torch.zeros(1, dtype=torch.int64, device="cuda")
    got = center_argmin(*args, kept_pairs=kept)
    torch.cuda.synchronize()
    assert torch.equal(got, center_argmin_reference(*args))
    mask = center_candidates_reference(*cpu_args)
    assert int(kept) == int(mask.sum()) < mask.numel()


def _warp_case(b, c, h, w, oh, ow, seed=0):
    """Coords over [-1.3, 1.3] (corners off the image, fully off-image
    pixels) and exact integer pixel coords on the first row."""
    g = torch.Generator().manual_seed(seed)
    image = torch.rand(b, c, h, w, generator=g)
    coords = torch.rand(b, oh, ow, 2, generator=g) * 2.6 - 1.3
    coords[:, 0, :, 0] = -1.0 + 2.0 * (torch.arange(ow) % w) / (w - 1)
    coords[:, 0, :, 1] = -1.0
    return image.cuda(), coords.cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w,oh,ow", [(4, 3, 1024, 1024, 1024, 1024),
                                           (2, 3, 37, 53, 37, 53),
                                           (1, 1, 5, 7, 9, 4),
                                           (2, 3, 384, 1280, 384, 1280)])
def test_warp_kernel_matches_plain_version(b, c, h, w, oh, ow):
    _need_card()
    image, coords = _warp_case(b, c, h, w, oh, ow)
    before = warp_bilinear.launches
    got = warp_bilinear(image, coords)
    torch.cuda.synchronize()
    assert warp_bilinear.launches == before + 1
    for g, r in zip(got, warp_bilinear_reference(image, coords)):
        assert g.shape == (b, c, oh, ow)
        assert torch.equal(g, r)
    value, gx, gy = warp_bilinear(image, coords, with_grads=False)
    assert gx is None and gy is None and torch.equal(value, got[0])


@pytest.mark.gpu
def test_warp_kernel_refuses_border_padding():
    _need_card()
    from mgnet_tpu_torch.geometry.image import grid_sample_planar

    image, coords = _warp_case(1, 3, 8, 8, 8, 8)
    with pytest.raises(ValueError, match="border"):
        grid_sample_planar(image, coords, "border")


def _ssim_case(b, c, h, w, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(b, c, h, w, generator=g)
    y = (x + 0.2 * torch.randn(b, c, h, w, generator=g)).clamp(0, 1)
    return x.cuda(), y.cuda(), torch.rand(b, h, w, generator=g).cuda()


# the training step's shape; ragged and degenerate planes; one row and
# one column past a multiple of the backward's 16-row, 30-column output
# tile; a plane lower than one tile; the KITTI training shape
# (configs/MGNet-KITTI-Eigen-Zhou.yaml); C = 2, which the forward runs in
# its kernel for any C; one row and one column past a multiple of the
# forward's 6-row, 30-column tile
SSIM_SHAPES = [(4, 3, 1024, 1024), (2, 3, 37, 53), (1, 3, 2, 2),
               (1, 3, 3, 33), (1, 1, 17, 18), (1, 3, 129, 61),
               (2, 3, 13, 95), (2, 3, 384, 1280), (1, 2, 33, 61),
               (1, 3, 61, 61)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SSIM_SHAPES)
def test_ssim_forward_kernel_matches_plain_version(shape):
    _need_card()
    x, y, _ = _ssim_case(*shape)
    before = ssim_residual_fwd.launches
    got = ssim_residual_fwd(x, y, 0.85)
    torch.cuda.synchronize()
    assert ssim_residual_fwd.launches == before + 1
    assert torch.equal(got, ssim_residual_reference(x, y, 0.85))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SSIM_SHAPES)
def test_ssim_backward_kernel_matches_plain_version(shape):
    _need_card()
    x, y, g = _ssim_case(*shape)
    before = ssim_residual_bwd.launches
    dx, dy = ssim_residual_bwd(x, y, g, 0.85)
    torch.cuda.synchronize()
    assert ssim_residual_bwd.launches == before + 1
    rx, ry = ssim_residual_bwd_reference(x, y, g, 0.85)
    assert torch.equal(dx, rx) and torch.equal(dy, ry)


@pytest.mark.gpu
def test_fused_residual_autograd_launches_both_kernels():
    _need_card()
    x, y, g = _ssim_case(2, 3, 40, 56)
    xr = x.clone().requires_grad_()
    before = (ssim_residual_fwd.launches, ssim_residual_bwd.launches)
    (fused_photometric_residual(xr, y) * g).sum().backward()
    torch.cuda.synchronize()
    assert (ssim_residual_fwd.launches, ssim_residual_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(xr.grad, ssim_residual_bwd_reference(x, y, g)[0])


def _train_launches(accum, remat, b=4, h=128, w=256):
    """One bf16 step of a narrow joint model on the card: the kernel
    launches it made and the state after it."""
    from mgnet_tpu_torch.config import get_default_config
    from mgnet_tpu_torch.data import synthetic_train_batch
    from mgnet_tpu_torch.models import build_model, init_random_
    from mgnet_tpu_torch.train import create_train_state, make_train_step

    cfg = get_default_config()
    cfg.MODEL.GCM.GCM_CHANNELS = 32
    for head in (cfg.MODEL.SEM_SEG_HEAD, cfg.MODEL.INS_EMBED_HEAD,
                 cfg.MODEL.DEPTH_HEAD):
        head.HEAD_CHANNELS, head.FFM_CHANNELS = 32, 48
        head.ARM_CHANNELS, head.REFINE_CHANNELS = [32, 32], [32, 32]
    cfg.MODEL.SEM_SEG_HEAD.OHEM_N_MIN = 3000
    cfg.SOLVER.GRAD_ACCUM_STEPS = accum
    cfg.MODEL.REMAT = remat
    model = build_model(cfg, device="cpu", for_training=True)
    init_random_(model, torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model.cuda())
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             synthetic_train_batch(b, h, w, seed=1).items()}
    before = (warp_bilinear.launches, ssim_residual_fwd.launches,
              ssim_residual_bwd.launches)
    _, metrics = make_train_step(cfg)(state, batch)
    torch.cuda.synchronize()
    launched = tuple(n - m for n, m in zip(
        (warp_bilinear.launches, ssim_residual_fwd.launches,
         ssim_residual_bwd.launches), before))
    assert all(torch.isfinite(v) for v in metrics.values()), metrics
    return launched, state


@pytest.mark.gpu
def test_accumulation_step_launches_per_micro_batch():
    """bf16, batch 4 as 2 x 2: per micro-batch the warp per context frame
    and scale (2 x 3), the SSIM forward per candidate (2 x 4), its
    backward per warped candidate (2 x 3)."""
    _need_card()
    launched, _ = _train_launches(accum=2, remat=False)
    assert launched == (2 * 6, 2 * 8, 2 * 6)


@pytest.mark.gpu
def test_remat_step_relaunches_the_forward_kernels():
    """MODEL.REMAT recomputes the photometric loss in the backward: the
    warp and SSIM forward launch twice, the backward once; the BN running
    statistics update once, as without REMAT."""
    _need_card()
    plain, plain_state = _train_launches(accum=1, remat=False)
    remat, remat_state = _train_launches(accum=1, remat=True)
    assert plain == (6, 8, 6) and remat == (12, 16, 6)
    a = plain_state.params.state_dict()
    b = remat_state.params.state_dict()
    stats = [k for k in a if k.endswith(("running_mean", "running_var"))]
    assert stats and all(torch.equal(a[k], b[k]) for k in stats)


ROOT = Path(__file__).resolve().parent.parent
FINE = str(ROOT / "configs" / "MGNet-Cityscapes-Fine.yaml")


def _mini_opts(out):
    opts = {"MODEL.GCM.GCM_CHANNELS": 32, "SOLVER.IMS_PER_BATCH": 2,
            "SOLVER.MAX_ITER": 1, "TEST.EVAL_PERIOD": 0,
            "MODEL.SEM_SEG_HEAD.OHEM_N_MIN": 2000, "OUTPUT_DIR": str(out),
            "WRITE_OUTPUT_TO_SUBDIR": False, "MODEL.WEIGHTS": "",
            "INPUT.MIN_SIZE_TRAIN": (96, 128), "INPUT.MAX_SIZE_TRAIN": 512,
            "INPUT.CROP.SIZE": (64, 96), "DATALOADER.NUM_WORKERS": 2}
    for head in ("SEM_SEG_HEAD", "INS_EMBED_HEAD", "DEPTH_HEAD"):
        opts.update({f"MODEL.{head}.HEAD_CHANNELS": 32,
                     f"MODEL.{head}.FFM_CHANNELS": 48,
                     f"MODEL.{head}.ARM_CHANNELS": [32, 32],
                     f"MODEL.{head}.REFINE_CHANNELS": [32, 32]})
    return [str(x) for kv in opts.items() for x in kv]


@pytest.mark.gpu
def test_loader_batch_reaches_the_card_pinned(tmp_path):
    """TrainLoader(pin_memory=True) yields page-locked tensors; to_device
    puts each on the card with its dtype and values."""
    _need_card()
    import numpy as np

    from mgnet_tpu_torch.config import load_config
    from mgnet_tpu_torch.data import (
        DatasetCatalog,
        TrainDatasetMapper,
        TrainLoader,
        collate_batch,
        register_all_cityscapes_scene_seg,
        to_device,
        write_cityscapes_tree,
    )
    from mgnet_tpu_torch.tools import train_net

    write_cityscapes_tree(str(tmp_path), 3, 128, 256)
    DatasetCatalog.clear()
    register_all_cityscapes_scene_seg(str(tmp_path))
    args = train_net.parse_args(["--config-file", FINE,
                                 *_mini_opts(tmp_path / "out")])
    cfg = load_config(args.config_file, args.opts)
    dicts = DatasetCatalog.get(cfg.DATASETS.TRAIN[0])
    mapper = TrainDatasetMapper(cfg)
    loader = TrainLoader(dicts, mapper, batch_size=2, seed=3,
                         num_workers=2, pin_memory=True)
    batch = next(iter(loader))
    loader.close()
    samples = [mapper(dicts[j], rng=np.random.default_rng((3, 0, j)))
               for j in np.random.default_rng(3).permutation(len(dicts))[:2]]
    for s in samples:
        s.pop("image_id")
    want = collate_batch(samples)
    on_card = to_device(batch, "cuda")
    torch.cuda.synchronize()
    assert batch.keys() == want.keys()
    for k, t in batch.items():
        assert t.is_pinned(), k
        assert on_card[k].is_cuda and on_card[k].dtype == t.dtype, k
        assert np.array_equal(on_card[k].cpu().numpy(), want[k]), k
    DatasetCatalog.clear()


@pytest.mark.gpu
def test_trainer_step_on_a_mini_tree_launches_the_kernels(tmp_path):
    """One bf16 Trainer iteration from a tree on disk through train_net:
    the warp, SSIM forward and SSIM backward launch 6 / 8 / 6 times, the
    losses are finite, and the run ends with model_final."""
    _need_card()
    import json

    from mgnet_tpu_torch.data import DatasetCatalog, write_cityscapes_tree
    from mgnet_tpu_torch.tools import train_net

    write_cityscapes_tree(str(tmp_path), 3, 128, 256)
    DatasetCatalog.clear()
    before = (warp_bilinear.launches, ssim_residual_fwd.launches,
              ssim_residual_bwd.launches)
    trainer = train_net.main([
        "--config-file", FINE, "--data-root", str(tmp_path),
        *_mini_opts(tmp_path / "out")])
    torch.cuda.synchronize()
    launched = tuple(n - m for n, m in zip(
        (warp_bilinear.launches, ssim_residual_fwd.launches,
         ssim_residual_bwd.launches), before))
    assert launched == (6, 8, 6) and trainer.state.step == 1
    line = json.loads((tmp_path / "out" / "metrics.json").read_text()
                      .splitlines()[0])
    assert all(torch.isfinite(torch.tensor(v)) for v in line.values())
    assert (tmp_path / "out" / "model_final" / "params.pt").is_file()
    DatasetCatalog.clear()


# the evaluation's fusion shapes: TEST.IMS_PER_BATCH 4 and its pow2 tails
# at 1024x2048, and a frame of another original size (1000x2000, not a
# multiple of the 32 x 32 tile) alone and in a batch
@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w", [(4, 1024, 2048), (2, 1024, 2048),
                                   (1, 1000, 2000), (4, 1000, 2000)])
def test_center_argmin_kernel_at_the_eval_shapes(b, h, w):
    _need_card()
    args = _center_case(b, h, w, 128, seed=b)
    before = center_argmin.launches
    got = center_argmin(*args)
    torch.cuda.synchronize()
    assert center_argmin.launches == before + 1
    assert torch.equal(got, center_argmin_reference(*args))


def _eval_on(device, cfg, model, out):
    """evaluate_dataset of ``model`` moved to ``device``, and the panoptic
    maps its PanopticEvaluator was given."""
    from mgnet_tpu_torch.evaluation.panoptic import PanopticEvaluator
    from mgnet_tpu_torch.train.trainer import evaluate_dataset

    process = PanopticEvaluator.process

    def keeping(self, pred, *args, **kwargs):
        out.append(pred.copy())
        return process(self, pred, *args, **kwargs)

    PanopticEvaluator.process = keeping
    try:
        return evaluate_dataset(cfg, model.to(device))
    finally:
        PanopticEvaluator.process = process


@pytest.mark.gpu
def test_eval_batch_on_the_card_matches_the_cpu(tmp_path):
    """The f32 evaluate_dataset on the card and on the CPU, each against
    the same call with the model's float64 reference on the CPU
    (models.as_float64_), on a mini val tree (a full batch of 4, a pow2
    tail and a second bucket key), with one seeded narrow model (the JAX
    package's init, whose BN at identity amplifies float32 rounding in
    eval mode), TF32 off: each panoptic map agrees with the float64 one on
    >= 99.9% of pixels, the metric dicts have its keys, and every value
    agrees with it within the CPU tests' bar, 1e-4 relative (1e-4
    absolute), apart from depth/scale_ratio_median: a median of the depth
    that the eval loop compacts to float16, it moves by half a float16 ulp
    when one pixel at an image's median rounds the other way, and is held
    within one float16 ulp, 2^-10 relative (chip_smoke.py's
    EVAL_F64_MEDIAN_REL)."""
    _need_card()
    import copy

    import numpy as np

    from mgnet_tpu_torch.config import get_default_config
    from mgnet_tpu_torch.data import (
        DatasetCatalog,
        MetadataCatalog,
        register_all_cityscapes_scene_seg,
        write_cityscapes_tree,
    )
    from mgnet_tpu_torch.models import as_float64_, build_model, init_random_

    write_cityscapes_tree(str(tmp_path), 0, 128, 256,
                          val_sizes=[(128, 256)] * 6 + [(120, 240)])
    DatasetCatalog.clear()
    MetadataCatalog.clear()
    register_all_cityscapes_scene_seg(str(tmp_path))
    cfg = get_default_config()
    cfg.MODEL.COMPUTE_DTYPE = "float32"
    cfg.MODEL.GCM.GCM_CHANNELS = 32
    h = cfg.MODEL.SEM_SEG_HEAD
    h.ARM_CHANNELS, h.REFINE_CHANNELS = [32, 32], [32, 32]
    h.FFM_CHANNELS, h.HEAD_CHANNELS = 48, 32
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 128, 256
    cfg.TEST.EVAL_INSTANCE = True
    # random heads predict no road: without DGC the depth is not all 0
    cfg.MODEL.POST_PROCESSING.USE_DGC_SCALING = False
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pans = {"f64": [], "cpu": [], "cuda": []}
    try:
        want = _eval_on("cpu", cfg, as_float64_(copy.deepcopy(model)),
                        pans["f64"])
        got = {"cpu": _eval_on("cpu", cfg, model, pans["cpu"])}
        before = center_argmin.launches
        got["cuda"] = _eval_on("cuda", cfg, model, pans["cuda"])
        assert center_argmin.launches - before == 3  # 4 + 2, then 1
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        DatasetCatalog.clear()
    for device in ("cpu", "cuda"):
        assert len(pans[device]) == len(pans["f64"]) == 7
        agree = [float((g == w).mean()) for g, w in zip(pans[device],
                                                        pans["f64"])]
        errs = {f"{group}/{k}": abs(got[device][group][k] - v)
                / max(abs(v), 1.0) for group in want if group != "eval_speed"
                for k, v in want[group].items()}
        print(f"{device} against float64: panoptic agreement {agree}, "
              f"worst metric {max(errs.values()):.3e} "
              f"({max(errs, key=errs.get)})")
        assert min(agree) >= 0.999
        assert list(got[device]) == list(want)
        for group in want:
            if group == "eval_speed":
                continue
            assert list(got[device][group]) == list(want[group]), group
            for k, v in want[group].items():
                assert np.isfinite(got[device][group][k]), (group, k)
                rtol = 2 ** -10 if k == "scale_ratio_median" else 1e-4
                np.testing.assert_allclose(
                    got[device][group][k], v, rtol=rtol, atol=1e-4,
                    err_msg=f"{device}: {group}/{k}")


def _serving_predictors(tta=False):
    """A seeded narrow f32 Predictor on the card and one on the CPU with
    the same weights, at a test size of 128x256."""
    from mgnet_tpu_torch.config import get_default_config
    from mgnet_tpu_torch.inference import Predictor
    from mgnet_tpu_torch.models import build_model, init_random_

    cfg = get_default_config()
    cfg.MODEL.WEIGHTS = ""
    cfg.MODEL.COMPUTE_DTYPE = "float32"
    cfg.MODEL.GCM.GCM_CHANNELS = 32
    h = cfg.MODEL.SEM_SEG_HEAD
    h.ARM_CHANNELS, h.REFINE_CHANNELS = [32, 32], [32, 32]
    h.FFM_CHANNELS, h.HEAD_CHANNELS = 48, 32
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 128, 256
    cfg.TEST.MSC_FLIP_EVAL = tta
    calib = {"intrinsic": {"fx": 180.0, "fy": 181.0, "u0": 159.5,
                           "v0": 79.5}, "extrinsic": {"z": 1.3}}
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    cpu = Predictor(cfg, model=model, calibration_info=calib,
                    dataset_name="gpu_serving", device="cpu")
    card = Predictor(cfg, model=build_model(cfg, device="cpu"),
                     calibration_info=calib, dataset_name="gpu_serving")
    card.model.load_state_dict(model.state_dict())
    return cpu, card


def _images(n, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (160, 320, 3)).astype(np.uint8)
            for _ in range(n)]


@pytest.mark.gpu
def test_predictor_on_the_card_is_the_frame_and_matches_the_cpu():
    """Each Predictor call on the card launches center_argmin once and
    equals, bit for bit, the frame called directly on the same resized
    image and camera; against the CPU (TF32 off) the panoptic maps agree
    on >= 99.9% of pixels and the depth within 1e-4 where they agree."""
    _need_card()
    import numpy as np

    from mgnet_tpu_torch.inference import build_fused_inference

    cpu, card = _serving_predictors()
    cfg = card.cfg
    direct = build_fused_inference(card.model, card.statics,
                                   cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for img in _images(2):
            before = center_argmin.launches
            got = card(img)
            assert center_argmin.launches == before + 1
            resized, K, height = card.prepare(img)
            want = direct(resized[None], K[None],
                          np.array([height], np.float32))
            assert list(got) == list(want)
            for k, v in want.items():
                assert np.array_equal(got[k], v[0].cpu().numpy(),
                                      equal_nan=True), k
            ref = cpu(img)
            same = got["panoptic"] == ref["panoptic"]
            assert same.mean() >= 0.999
            np.testing.assert_allclose(got["depth"][same],
                                       ref["depth"][same], rtol=1e-4,
                                       atol=1e-4)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


@pytest.mark.gpu
@pytest.mark.parametrize("tta", [False, True])
def test_predict_batch_filter_on_the_card(tta):
    """outputs=('panoptic',) equals the full dict's panoptic, one
    center_argmin launch a batch; materialize=False keeps it on the
    card."""
    _need_card()
    import numpy as np

    _, card = _serving_predictors(tta)
    batch = np.stack([card.prepare(i)[0] for i in _images(3, seed=1)])
    before = center_argmin.launches
    full = card.predict_batch(batch)
    only = card.predict_batch(batch, outputs=("panoptic",))
    lazy = card.predict_batch(batch, outputs=("panoptic",),
                              materialize=False)
    assert center_argmin.launches == before + 3
    assert list(only) == ["panoptic"]
    assert np.array_equal(only["panoptic"], full["panoptic"])
    assert lazy["panoptic"].device.type == "cuda"
    assert np.array_equal(lazy["panoptic"].cpu().numpy(), full["panoptic"])


# bar (iii): two ranks on the card against one, where cuDNN may pick
# other algorithms at the ranks' batch than at the global one
DIST_REL, DIST_COS_MEDIAN, DIST_COS_WORST = 1e-4, 1e-4, 2e-3


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    """Both training steps of tests/_torch_mp_train_worker.py (plain at
    one sample per rank; GRAD_ACCUM_STEPS 2 + MODEL.REMAT at two) in two
    gloo ranks sharing the card, and in one rank on the CPU with the
    model's float64 reference, from the same seeded state: ({case: [rank
    results]}, {case: one-rank float64 result})."""
    _need_card()
    import os
    import socket
    import subprocess
    import sys

    import _torch_mp_train_worker as w

    from mgnet_tpu_torch.models import build_model, init_random_
    from mgnet_tpu_torch.train import create_train_state

    out = tmp_path_factory.mktemp("card_ranks")
    cfg = w.step_config()
    model = build_model(cfg, device="cpu", for_training=True)
    init_random_(model, torch.Generator().manual_seed(0))
    state_dict = create_train_state(cfg, model).params.state_dict()
    torch.save(state_dict, out / "state.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_mp_train_worker.py"),
         str(r), str(port), str(out / "state.pt"), str(out), "cuda"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(w.WORLD)]
    logs = [p.communicate(timeout=900)[0] for p in ranks]
    for p, log in zip(ranks, logs):
        assert p.returncode == 0, log[-3000:]
    got = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(w.WORLD)]
    ref = {k: w.step_case(state_dict, *v, 0, 1, "cpu", float64=True)
           for k, v in w.STEP_CASES.items()}
    return {k: [g[k] for g in got] for k in ref}, ref


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["step/plain", "step/accum_remat"])
def test_two_gloo_ranks_on_one_card_equal_one_rank(card_ranks, case):
    """f32 on the card: the losses, the gradients (per-leaf cosine) and
    the BN running statistics (per tensor, against its largest magnitude)
    of two gloo ranks at the global batch equal one rank's within bar
    (iii), where the one rank is the step with the model's float64
    reference on the CPU: the seeded model (the JAX package's init)
    amplifies float32 rounding, so the ranks are held to float64 rather
    than to another float32 run. Both ranks hold the same parameters bit
    for bit."""
    got, ref = card_ranks[0][case], card_ranks[1][case]
    want = ref["metrics"]
    for name, g in ((f"rank {r}", x) for r, x in enumerate(got)):
        rel = {k: abs(g["metrics"][k] - v) / max(abs(v), 1e-6)
               for k, v in want.items() if k != "grad_norm"}
        dists = {}
        for n, b in ref["grads"].items():
            a, b = g["grads"][n].double().flatten(), b.double().flatten()
            den = float(a.norm() * b.norm())
            dists[n] = 0.0 if den == 0 else 1.0 - float(a @ b) / den
        stats = {k: float((g["stats"][k].double() - v).abs().max()
                          / v.abs().max()) for k, v in ref["stats"].items()}
        median = sorted(dists.values())[len(dists) // 2]
        print(f"{case}, {name} against float64: losses worst "
              f"{max(rel.values()):.2e}, gradient cosine distance median "
              f"{median:.2e}, worst {max(dists.values()):.2e}; running "
              f"statistics worst {max(stats.values()):.2e}")
        assert max(rel.values()) < DIST_REL, (name, rel)
        assert median < DIST_COS_MEDIAN, name
        assert max(dists.values()) < DIST_COS_WORST, name
        assert max(stats.values()) < DIST_REL, (name, max(stats,
                                                          key=stats.get))
    for k, v in got[0]["params"].items():
        assert torch.equal(v, got[1]["params"][k]), k


@pytest.fixture(scope="module")
def card_package(tmp_path_factory):
    """The narrow float32 frame (32-channel heads, seeded weights) on the
    card at 1x64x128 with a camera, exported and compiled by AOTInductor:
    (frame, package, package path, inputs with the runner's camera)."""
    _need_card()
    from mgnet_tpu_torch.config import get_default_config
    from mgnet_tpu_torch.data import (
        CITYSCAPES_SCENE_SEG_CATEGORIES,
        Metadata,
        build_meta,
    )
    from mgnet_tpu_torch.export import (
        export_fused_inference,
        load_exported,
        save_exported,
    )
    from mgnet_tpu_torch.inference import (
        build_fused_inference,
        statics_from_meta,
    )
    from mgnet_tpu_torch.models import build_model, init_random_

    cfg = get_default_config()
    cfg.MODEL.COMPUTE_DTYPE = "float32"
    cfg.MODEL.GCM.GCM_CHANNELS = 32
    h = cfg.MODEL.SEM_SEG_HEAD
    h.ARM_CHANNELS, h.REFINE_CHANNELS = [32, 32], [32, 32]
    h.FFM_CHANNELS, h.HEAD_CHANNELS = 48, 32
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    model.cuda().eval()
    statics = statics_from_meta(cfg, Metadata(name="t").set(
        **build_meta(CITYSCAPES_SCENE_SEG_CATEGORIES)))
    frame = build_fused_inference(model, statics, cfg.MODEL.PIXEL_MEAN,
                                  cfg.MODEL.PIXEL_STD, device="cuda")
    program, blob = export_fused_inference(frame, (1, 64, 128, 3))
    path = tmp_path_factory.mktemp("card_export") / "frame.pt2"
    pkg, _ = save_exported(path, program, blob)
    g = torch.Generator().manual_seed(3)
    image = torch.randint(0, 256, (1, 64, 128, 3), generator=g).float()
    inputs = (image.cuda(),
              torch.tensor([[[2262.52, 0.0, 1096.98], [0.0, 2265.30, 513.137],
                             [0.0, 0.0, 1.0]]], device="cuda"),
              torch.tensor([1.22], device="cuda"))
    return frame, load_exported(path), pkg, inputs


@pytest.mark.gpu
def test_package_on_the_card_matches_the_eager_frame(card_package):
    """The AOTInductor package launches the hand-written center_argmin
    once a frame and matches the eager frame at the float32 bars (TF32 off
    for both: the convolutions are cuDNN's in both, at the same flags)."""
    from mgnet_tpu_torch.export import BARS, compare_outputs

    frame, package, _, inputs = card_package
    allow = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = center_argmin.launches
        got = package(*inputs)
        torch.cuda.synchronize()
        assert center_argmin.launches == before + 1
        want = frame(*inputs)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = allow
    # tests/test_torch_fused.py's bars, on every value
    found = compare_outputs(got, want, frame.statics,
                            *BARS[torch.float32][:3], 1.0)
    print(f"package against eager on the card: {found}")


@pytest.mark.gpu
def test_runner_checksum_equals_the_package(card_package, tmp_path):
    """The C++ runner (built at first use) runs the same package on the
    same image with the same camera: its FNV-1a of the panoptic output is
    the Python-loaded package's, and it launches the kernel once a frame."""
    import subprocess

    from mgnet_tpu_torch.export import fnv1a64
    from mgnet_tpu_torch.ops._build import build_runner

    _, package, pkg, inputs = card_package
    exe, _ = build_runner()
    raw = tmp_path / "image.raw"
    inputs[0].cpu().numpy().tofile(raw)
    res = subprocess.run([str(exe), str(pkg), str(raw), "5", "64", "128"],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    fnv = int(res.stdout.split("fnv1a=")[1].split()[0], 16)
    assert fnv == fnv1a64(package(*inputs)["panoptic"]), res.stdout
    assert "center_argmin launches: 16 in 16 frames" in res.stdout


@pytest.mark.gpu
def test_gt_depth_ablation_descends_through_the_kernels(capsys):
    """50 steps of validate_depth_overfit --mode gt_depth on the card: the
    photometric loss falls, and every step went through the hand-written
    warp and SSIM kernels (two context frames: 2 warps, 2 SSIM forwards
    and 2 SSIM backwards a step, and the loss at the analytic truth once
    without gradients)."""
    _need_card()
    from mgnet_tpu_torch.tools import validate_depth_overfit

    for k in (warp_bilinear, ssim_residual_fwd, ssim_residual_bwd):
        k.launches = 0
    validate_depth_overfit.main(["--mode", "gt_depth", "--steps", "50"])
    launches = [k.launches for k in (warp_bilinear, ssim_residual_fwd,
                                     ssim_residual_bwd)]
    losses = [float(ln.split("photometric ")[1])
              for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("  step ")]
    # printed at every 50 // 8 = 6th step and the last
    assert len(losses) == 10 and losses[-1] < losses[0]
    assert launches == [2 * 50 + 2, 2 * 50 + 2, 2 * 50], launches
