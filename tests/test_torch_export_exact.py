"""``export_inference --verify``'s exact step in the shipped dtype, on the
CPU: the ``ExportedProgram`` of a bfloat16 frame (the Fine YAML's
``MODEL.COMPUTE_DTYPE``; narrow seeded heads, 1x32x64) runs the casts that
``torch.export`` captured from autocast, so reloaded from its bytes it
equals the eager bfloat16 frame bit for bit on every key, as
``export.compare_exact`` holds it. And ``compare_exact`` itself: NaN where
NaN is equal, one ulp anywhere is not, and keys, shapes and dtypes must
match.
"""

from __future__ import annotations

import pytest
import torch

from mgnet_tpu_torch.config import load_config
from mgnet_tpu_torch.data import (
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    Metadata,
    build_meta,
)
from mgnet_tpu_torch.export import (
    compare_exact,
    export_fused_inference,
    load_program,
)
from mgnet_tpu_torch.inference import build_fused_inference, statics_from_meta
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.tools.export_inference import verify_inputs

H, W = 32, 64
NARROW = ["MODEL.GCM.GCM_CHANNELS", "32",
          "MODEL.SEM_SEG_HEAD.ARM_CHANNELS", "[32, 32]",
          "MODEL.SEM_SEG_HEAD.REFINE_CHANNELS", "[32, 32]",
          "MODEL.SEM_SEG_HEAD.FFM_CHANNELS", "48",
          "MODEL.SEM_SEG_HEAD.HEAD_CHANNELS", "32"]


@pytest.fixture(scope="module")
def bf16(tmp_path_factory):
    """(the reloaded program's outputs, the eager frame's) on the tool's
    verification inputs."""
    cfg = load_config("configs/MGNet-Cityscapes-Fine.yaml", NARROW)
    assert cfg.MODEL.COMPUTE_DTYPE == "bfloat16"
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(cfg.SEED))
    statics = statics_from_meta(cfg, Metadata(name="exact").set(
        **build_meta(CITYSCAPES_SCENE_SEG_CATEGORIES)))
    frame = build_fused_inference(model, statics, cfg.MODEL.PIXEL_MEAN,
                                  cfg.MODEL.PIXEL_STD, device="cpu")
    _, blob = export_fused_inference(frame, (1, H, W, 3))
    path = tmp_path_factory.mktemp("exact") / "frame.pt2"
    path.write_bytes(blob)
    inputs = verify_inputs(H, W, "cpu")
    return load_program(path)(*inputs), frame(*inputs)


def test_bf16_program_equals_the_eager_frame_bit_for_bit(bf16):
    got, want = bf16
    counted = compare_exact(got, want)
    assert counted == {"center": H * W, "depth": H * W, "offset": 2 * H * W,
                       "panoptic": H * W, "points": 3 * H * W,
                       "sem_seg": H * W}


def test_compare_exact_takes_nan_for_nan():
    a = {"x": torch.tensor([1.0, float("nan")]), "y": torch.tensor([3])}
    assert compare_exact(a, {k: v.clone() for k, v in a.items()}) == \
        {"x": 2, "y": 1}


@pytest.mark.parametrize("change", ["ulp", "nan", "dtype", "shape", "key"])
def test_compare_exact_refuses_any_difference(change):
    want = {"x": torch.tensor([1.0, 2.0]), "y": torch.tensor([3])}
    got = {k: v.clone() for k, v in want.items()}
    if change == "ulp":
        got["x"][1] = torch.nextafter(got["x"][1], torch.tensor(3.0))
    elif change == "nan":
        got["x"][0] = float("nan")
    elif change == "dtype":
        got["y"] = got["y"].int()
    elif change == "shape":
        got["x"] = got["x"][:1]
    else:
        got["z"] = got.pop("y")
    with pytest.raises(AssertionError):
        compare_exact(got, want)
