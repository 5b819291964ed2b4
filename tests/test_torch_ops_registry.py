"""The hand-written kernels as ``torch.library`` custom ops, on the CPU.

``mgnet::center_argmin``, ``mgnet::warp_bilinear`` and
``mgnet::ssim_residual_{fwd,bwd}`` pass ``torch.library.opcheck`` (schema,
fake against real, aliasing, tracing with dynamic shapes) on small CPU
inputs, whose kernel is the plain version; their fakes give the real
outputs' shapes and dtypes; each has exactly a CPU and a CUDA kernel (no
composite fallback, so a CUDA tensor reaches the hand-written launch or
raises); the C++ registration of ``export/csrc/mgnet_ops.cpp`` declares
the Python op's schema; and the class vote's fixed-size scatter equals
``bincount``.
"""

from __future__ import annotations

import importlib
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mgnet_tpu_torch.export import compare_outputs, fnv1a64, package_path
from mgnet_tpu_torch.ops import _build
from mgnet_tpu_torch.ops import ssim as ops_ssim
from mgnet_tpu_torch.ops import warp as ops_warp
from mgnet_tpu_torch.inference import PostprocessStatics, fusion_kwargs
from mgnet_tpu_torch.ops.center_argmin import (
    center_argmin_reference,
    center_inputs,
)
from mgnet_tpu_torch.postprocessing.panoptic import (
    panoptic_fusion,
    vote_counts,
)

# the module (the package's ``center_argmin`` is the function)
ops_center_argmin = importlib.import_module(
    "mgnet_tpu_torch.ops.center_argmin")
ROOT = Path(__file__).resolve().parent.parent
OPS = ("center_argmin", "warp_bilinear", "ssim_residual_fwd",
       "ssim_residual_bwd")


def _inputs(op: str, shape, seed: int = 0):
    """Seeded CPU arguments of ``op`` at ``shape``: (B, H, W, K) for
    center_argmin, (B, C, H, W) otherwise (the warp samples at H-1 x W+1
    points, half of them off the image)."""
    rng = np.random.RandomState(seed)

    def f32(*s, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (rng.rand(*s) * scale + shift).astype(np.float32))

    if op == "center_argmin":
        b, h, w, k = shape
        centers = f32(b, k, 2) * torch.tensor([h, w], dtype=torch.float32)
        valid = torch.from_numpy(rng.rand(b, k) > 0.3)
        return (f32(b, h, w, scale=h), f32(b, h, w, scale=w),
                *center_inputs(centers, valid))
    b, c, h, w = shape
    if op == "warp_bilinear":
        return (f32(b, c, h, w), f32(b, h - 1, w + 1, 2, scale=3.0,
                                     shift=-1.5), True)
    if op == "ssim_residual_fwd":
        return f32(b, c, h, w), f32(b, c, h, w), 0.85
    return f32(b, c, h, w), f32(b, c, h, w), f32(b, h, w), 0.85


SHAPES = {"center_argmin": [(1, 8, 12, 5), (2, 33, 17, 40)],
          "warp_bilinear": [(1, 3, 6, 9), (2, 2, 11, 7)],
          "ssim_residual_fwd": [(1, 3, 5, 7), (2, 1, 9, 4)],
          "ssim_residual_bwd": [(1, 3, 5, 7), (2, 1, 9, 4)]}
CASES = [(op, shape) for op in OPS for shape in SHAPES[op]]


def _op(name: str):
    return getattr(torch.ops.mgnet, name).default


@pytest.mark.parametrize("name,shape", CASES)
def test_opcheck(name, shape):
    torch.library.opcheck(_op(name), _inputs(name, shape))


def test_warp_without_grads_passes_opcheck():
    args = _inputs("warp_bilinear", (2, 3, 6, 5))[:2]
    torch.library.opcheck(_op("warp_bilinear"), (*args, False))


@pytest.mark.parametrize("name,shape", CASES)
def test_fake_gives_the_real_shapes_and_dtypes(name, shape):
    args = _inputs(name, shape)
    real = _op(name)(*args)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args]
        fake = _op(name)(*fake_args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(tuple(t.shape), t.dtype) for t in fake] == \
        [(tuple(t.shape), t.dtype) for t in real]


@pytest.mark.parametrize("name", OPS)
def test_op_has_a_cpu_and_a_cuda_kernel_only(name):
    """A CPU kernel (the plain version) and a CUDA kernel (the launch),
    no composite one that could stand in for either."""
    qual = f"mgnet::{name}"
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(qual, "CPU") and has(qual, "CUDA")
    for key in ("CompositeImplicitAutograd", "CompositeExplicitAutograd"):
        assert not has(qual, key), key


@pytest.mark.parametrize("launch,args", [
    (ops_center_argmin._launch, ("center_argmin", (1, 4, 4, 2), None)),
    (ops_warp._launch, ("warp_bilinear", (1, 1, 4, 4), True)),
    (ops_ssim._launch_fwd, ("ssim_residual_fwd", (1, 1, 4, 4), 0.85)),
    (ops_ssim._launch_bwd, ("ssim_residual_bwd", (1, 1, 4, 4), 0.85)),
], ids=OPS)
def test_cuda_kernel_raises_on_a_cpu_tensor(launch, args):
    """The ops' CUDA kernels launch or raise: handed CPU tensors they raise
    rather than compute the plain version."""
    name, shape, extra = args
    tensors = [a for a in _inputs(name, shape)
               if isinstance(a, torch.Tensor)]
    with pytest.raises(ValueError, match="unsupported device"):
        launch(*tensors, extra)


@pytest.mark.parametrize("name,shape", CASES)
def test_public_wrapper_equals_the_op(name, shape):
    """The Python entry points call the ops: same outputs, no launch
    counted on the CPU."""
    args = _inputs(name, shape)
    wrapper = {"center_argmin": ops_center_argmin.center_argmin,
               "warp_bilinear": ops_warp.warp_bilinear,
               "ssim_residual_fwd": ops_ssim.ssim_residual_fwd,
               "ssim_residual_bwd": ops_ssim.ssim_residual_bwd}[name]
    before = wrapper.launches
    got = wrapper(*args)
    want = _op(name)(*args)
    assert wrapper.launches == before
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cpp_registration_declares_the_python_schema():
    """The runner's registration (mgnet_ops.cpp) and the Python op have one
    schema: a mismatch shows only when the runner calls the op."""
    src = (ROOT / "mgnet_tpu_torch" / "export" / "csrc" /
           "mgnet_ops.cpp").read_text()
    body = re.search(r"m\.def\(((?:\s*\"[^\"]*\")+)\)", src).group(1)
    declared = "".join(re.findall(r"\"([^\"]*)\"", body))
    schema = str(_op("center_argmin")._schema)
    assert "mgnet::" + declared == schema


def test_cpp_sources_compile_against_pytorch_headers(tmp_path):
    """export/csrc/*.cpp parse and type-check against this PyTorch's C++
    headers with the runner build's flags (g++ -fsyntax-only; no CUDA
    header is needed)."""
    flags, _ = _build._torch_flags()
    procs = [subprocess.Popen([_build._gxx(), *flags, "-fsyntax-only",
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src in sorted(_build.RUNNER_CSRC_DIR.glob("*.cpp"))]
    assert len(procs) == 2
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]


@pytest.mark.parametrize("b,h,w,k,c", [(1, 7, 9, 4, 3), (2, 16, 24, 129, 20),
                                       (3, 5, 64, 33, 19),
                                       (1, 32, 32, 1, 1)])
def test_vote_counts_equal_bincount(b, h, w, k, c):
    rng = np.random.RandomState(b * 1000 + k)
    cluster = torch.from_numpy(rng.randint(0, k, (b, h, w)))
    sem = torch.from_numpy(rng.randint(0, c, (b, h, w)))
    got = vote_counts(cluster, sem, k, c)
    batch = torch.arange(b)[:, None, None]
    pair = ((batch * k + cluster) * c + sem).reshape(-1)
    want = torch.bincount(pair, minlength=b * k * c).reshape(b, k, c)
    assert got.dtype == torch.int32 and torch.equal(got.long(), want)


def test_fnv1a64_known_values():
    assert fnv1a64(torch.tensor([], dtype=torch.uint8)) == 0xCBF29CE484222325
    assert fnv1a64(torch.tensor([97], dtype=torch.uint8)) == \
        0xAF63DC4C8601EC8C
    # an int32 tensor hashes its little-endian bytes
    assert fnv1a64(torch.tensor([97], dtype=torch.int32)) == fnv1a64(
        torch.tensor([97, 0, 0, 0], dtype=torch.uint8))


def test_package_path_beside_the_program():
    assert package_path("out/model.pt2") == Path("out/model.aoti.pt2")
    assert package_path("model") == Path("model.aoti.pt2")


STATICS = PostprocessStatics(num_classes=4, last_stuff_id=1, stuff_area=0,
                             max_instances=8)


def _frame_outputs():
    """Seeded frame outputs whose panoptic is the plain fusion of their own
    sem_seg, center and offset."""
    g = torch.Generator().manual_seed(0)
    sem = torch.randint(0, 4, (1, 8, 8), generator=g, dtype=torch.int32)
    center = torch.rand(1, 8, 8, generator=g)
    offset = torch.randint(-8, 9, (1, 8, 8, 2), generator=g) * 0.25
    pan = panoptic_fusion(sem, center, offset, **fusion_kwargs(STATICS),
                          argmin=center_argmin_reference)
    return {"sem_seg": sem, "panoptic": pan, "center": center,
            "offset": offset, "depth": 1.0 + torch.rand(1, 8, 8, generator=g),
            "points": torch.rand(1, 8, 8, 3, generator=g)}


@pytest.mark.parametrize("change,fails", [
    (None, None),
    ("want's instance ids", None),
    ("labels", "sem_seg equal on"),
    ("panoptic", "panoptic fusion equal on"),
    ("values", "depth 0.984375 of the values"),
    ("nan", "points NaN at other pixels"),
])
def test_compare_outputs_holds_each_bar(change, fails):
    """Labels and panoptic's classes on at least ``agree`` of the pixels,
    panoptic as the fusion of its own heads (the reference's instance ids
    may differ); of the rest, at least ``within`` of the values within
    atol + rtol * |want| where the classes agree, NaN where want has NaN;
    every failure named at once."""
    want = _frame_outputs()
    got = {k: v.clone() for k, v in want.items()}
    if change == "want's instance ids":
        thing = want["panoptic"] % 1000 > 0
        want["panoptic"][thing] += 1
    elif change == "labels":
        got["sem_seg"][0, :2] = (got["sem_seg"][0, :2] + 1) % 4
    elif change == "panoptic":
        got["panoptic"][0, :2] += 1000
    elif change == "values":
        got["depth"][0, 5, 5] += 0.5
    elif change == "nan":
        got["points"][0, 3, 3, 0] = float("nan")
    if fails is None:
        found = compare_outputs(got, want, STATICS, 0.999, 1e-4, 1e-4, 1.0)
        assert set(found["agree"].values()) == {1.0}
        assert set(found["within"]) == {"center", "offset", "depth",
                                        "points"}
        return
    with pytest.raises(AssertionError, match=fails):
        compare_outputs(got, want, STATICS, 0.999, 1e-4, 1e-4, 1.0)
    # one value off in 64 passes a bar of 0.98 of the values
    if change == "values":
        compare_outputs(got, want, STATICS, 0.999, 1e-4, 1e-4, 0.98)


@pytest.mark.parametrize("change,missed", [
    ("labels", {"sem_seg": 0.75, "panoptic fusion": 0.71875}),
    ("panoptic", {"panoptic classes": 0.75, "panoptic fusion": 0.75}),
    ("values", {"depth": 0.984375}),
    ("nan", {"points NaN": None, "points": 191 / 192}),
])
def test_compare_outputs_names_the_bars_it_missed(change, missed):
    """BarsMissed, an AssertionError, maps each bar missed to the share
    found (None for NaN at other pixels), and carries the whole result."""
    from mgnet_tpu_torch.export import BarsMissed

    want = _frame_outputs()
    got = {k: v.clone() for k, v in want.items()}
    if change == "labels":
        got["sem_seg"][0, :2] = (got["sem_seg"][0, :2] + 1) % 4
    elif change == "panoptic":
        got["panoptic"][0, :2] += 1000
    elif change == "values":
        got["depth"][0, 5, 5] += 0.5
    else:
        got["points"][0, 3, 3, 0] = float("nan")
    with pytest.raises(BarsMissed) as e:
        compare_outputs(got, want, STATICS, 0.999, 1e-4, 1e-4, 1.0)
    assert e.value.missed == missed
    assert set(e.value.found) == {"agree", "within", "max_abs"}
