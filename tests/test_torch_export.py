"""The port's export of the fused frame, on the CPU.

At ``tests/test_torch_fused.py``'s narrow setup (2x64x128, float32, the
flax-initialised weights, the same JAX frame), with and without a camera:
* ``export_fused_inference``'s ``ExportedProgram`` runs the same ATen ops
  as the eager frame, so its ``module()`` equals the eager port frame bit
  for bit on every key, and the JAX frame at that file's bars (labels on
  >= 99.9% of pixels; heads, depth and points within 1e-4 abs and rel
  where the panoptic maps agree);
* the hand-written ``center_argmin`` stays one opaque ``mgnet::center_argmin``
  call in the graph, and the shapes are static;
* the serialized bytes round-trip through ``torch.export.load``.
Then one AOTInductor round trip through the port's ``export_inference
--device cpu --verify`` at 1x64x128 on the same weights (a
``model_final`` written by ``save_params``): the tool's own checks, the
reloaded program against the live frame bit for bit, then the package
against the live frame (Inductor's fused code rounds differently
from eager, so at the float32 bars of ``export.BARS``), the package's one
proxy call of ``mgnet::center_argmin`` and its ``output_keys`` metadata,
and the package against the exported program it was compiled from at
this file's bars on every value.
"""

from __future__ import annotations

import contextlib
import io
import json
import zipfile

import jax.numpy as jnp  # noqa: F401  (test_torch_fused's JAX frame)
import numpy as np
import pytest
import torch

from mgnet_tpu_torch.config import load_config
from mgnet_tpu_torch.data import (
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    Metadata,
    build_meta,
)
from mgnet_tpu_torch.export import (
    BARS,
    compare_outputs,
    export_fused_inference,
    load_exported,
    package_path,
)
from mgnet_tpu_torch.inference import build_fused_inference, statics_from_meta
from mgnet_tpu_torch.tools import export_inference
from mgnet_tpu_torch.utils.checkpoint import save_params
from test_torch_fused import (  # noqa: F401  (module fixtures)
    AGREE,
    ATOL,
    B,
    H,
    RTOL,
    W,
    _frames,
    frames,
    setup,
)

KEYS = {"camera": ["sem_seg", "panoptic", "center", "offset", "depth",
                   "points"],
        "no_camera": ["sem_seg", "panoptic", "center", "offset", "depth"]}
PAIRS = [(sig, key) for sig, keys in KEYS.items() for key in keys]
NARROW = ["MODEL.COMPUTE_DTYPE", "float32",
          "MODEL.GCM.GCM_CHANNELS", "32",
          "MODEL.SEM_SEG_HEAD.ARM_CHANNELS", "[32, 32]",
          "MODEL.SEM_SEG_HEAD.REFINE_CHANNELS", "[32, 32]",
          "MODEL.SEM_SEG_HEAD.FFM_CHANNELS", "48",
          "MODEL.SEM_SEG_HEAD.HEAD_CHANNELS", "32"]


@pytest.fixture(scope="module")
def exports(setup, frames):
    """For each signature: the exported program, its bytes, its inputs,
    and the outputs of its module, the eager port frame and the JAX frame
    (numpy)."""
    cfg = setup["cfg"]
    frame = build_fused_inference(setup["model"], setup["statics"],
                                  cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                                  device="cpu")
    image, K, height = (torch.from_numpy(a) for a in setup["inputs"])
    jax_outputs = {"camera": frames[1],
                   "no_camera": _frames(setup, jit=False,
                                        with_camera=False)[1]}
    result = {}
    for sig in KEYS:
        args = (image, K, height) if sig == "camera" else (image,)
        program, blob = export_fused_inference(
            frame, (B, H, W, 3), with_camera=sig == "camera")
        with torch.no_grad():
            got = program.module()(*args)
        result[sig] = dict(program=program, blob=blob, args=args,
                           got={k: v.numpy() for k, v in got.items()},
                           eager={k: v.numpy()
                                  for k, v in frame(*args).items()},
                           jax=jax_outputs[sig])
    return result


@pytest.mark.parametrize("sig,key", PAIRS)
def test_program_equals_the_eager_frame(exports, sig, key):
    e = exports[sig]
    assert set(e["got"]) == set(e["eager"]) == set(KEYS[sig])
    assert e["got"][key].dtype == e["eager"][key].dtype
    np.testing.assert_array_equal(e["got"][key], e["eager"][key])


@pytest.mark.parametrize("sig,key", PAIRS)
def test_program_matches_the_jax_frame(exports, sig, key):
    e = exports[sig]
    got, want = e["got"], e["jax"]
    assert set(got) == set(want)
    assert got[key].shape == want[key].shape
    assert got[key].dtype == want[key].dtype
    if key in ("sem_seg", "panoptic"):
        assert (got[key] == want[key]).mean() >= AGREE
        return
    same = got["panoptic"] == want["panoptic"]
    g, w = (got[key], want[key]) if key in ("center", "offset") else \
        (got[key][same], want[key][same])
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("sig", list(KEYS))
def test_center_argmin_stays_one_opaque_call_at_static_shapes(exports, sig):
    program = exports[sig]["program"]
    calls = [n for n in program.graph.nodes
             if n.target is torch.ops.mgnet.center_argmin.default]
    assert len(calls) == 1
    assert tuple(calls[0].meta["val"].shape) == (B, H, W)
    for node in program.graph.nodes:
        val = node.meta.get("val")
        if isinstance(val, torch.Tensor):
            assert all(isinstance(d, int) for d in val.shape), node


@pytest.mark.parametrize("sig", list(KEYS))
def test_saved_bytes_round_trip(exports, sig, tmp_path):
    e = exports[sig]
    path = tmp_path / "frame.pt2"
    path.write_bytes(e["blob"])
    with torch.no_grad():
        out = torch.export.load(str(path)).module()(*e["args"])
    assert set(out) == set(KEYS[sig])
    for key, v in out.items():
        np.testing.assert_array_equal(v.numpy(), e["got"][key])


@pytest.fixture(scope="module")
def aoti(setup, tmp_path_factory):
    """export_inference --device cpu --verify at 1x64x128 on the setup's
    weights: (output path, what it printed)."""
    root = tmp_path_factory.mktemp("export")
    save_params(str(root / "model_final"), setup["model"])
    output = root / "frame.pt2"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = export_inference.main([
            "--config-file", "configs/MGNet-Cityscapes-Fine.yaml",
            "--weights", str(root / "model_final"), "--output", str(output),
            "--height", str(H), "--width", str(W), "--verify", "--device",
            "cpu", *NARROW])
    assert rc == 0
    return output, printed.getvalue()


def test_export_inference_writes_and_verifies_on_the_cpu(aoti):
    output, printed = aoti
    assert output.is_file() and package_path(output).is_file()
    assert f"Loaded {output.parent / 'model_final'}" in printed
    assert f"Wrote {output} ({output.stat().st_size} bytes)" in printed
    assert "PARITY OK on cpu" in printed


def test_export_inference_holds_the_program_exactly_before_the_package(aoti):
    """--verify's first step: the reloaded ExportedProgram equals the live
    frame bit for bit on every key; only then the package at BARS."""
    lines = aoti[1].splitlines()
    exact = [i for i, ln in enumerate(lines) if ln.startswith("EXACT OK")]
    parity = [i for i, ln in enumerate(lines) if ln.startswith("PARITY OK")]
    assert len(exact) == len(parity) == 1 and exact[0] < parity[0]
    # one image: 2 offset and 3 point channels, one value of each other key
    assert lines[exact[0]] == (
        f"EXACT OK on cpu: the ExportedProgram equals the live frame bit "
        f"for bit on every key ({9 * H * W} values of center, depth, "
        f"offset, panoptic, points, sem_seg)")


def test_package_calls_center_argmin_once_through_the_proxy(aoti):
    """The generated code leaves the op to the proxy executor: one extern
    node mgnet::center_argmin; the metadata names the outputs in order."""
    with zipfile.ZipFile(package_path(aoti[0])) as z:
        nodes = [n for name in z.namelist()
                 if name.endswith("wrapper.json")
                 for n in json.loads(z.read(name))["nodes"]]
        meta = [json.loads(z.read(name)) for name in z.namelist()
                if name.endswith("wrapper_metadata.json")]
    assert [n["node"]["target"] for n in nodes] == ["mgnet::center_argmin"]
    assert meta[0]["output_keys"] == ",".join(KEYS["camera"])


def test_package_matches_the_exported_program(aoti):
    output = aoti[0]
    cfg = load_config("configs/MGNet-Cityscapes-Fine.yaml", NARROW)
    statics = statics_from_meta(cfg, Metadata(name="export").set(
        **build_meta(CITYSCAPES_SCENE_SEG_CATEGORIES)))
    inputs = export_inference.verify_inputs(H, W, "cpu")
    got = load_exported(output)(*inputs)
    with torch.no_grad():
        want = torch.export.load(str(output)).module()(*inputs)
    # this file's bars on every value (the tool's own check allows the
    # share of values found at full width on the card)
    found = compare_outputs(got, want, statics, AGREE, ATOL, RTOL, 1.0)
    assert set(found["agree"]) == {"sem_seg", "panoptic classes",
                                   "panoptic fusion"}
    assert BARS[torch.float32][:3] == (AGREE, ATOL, RTOL)
