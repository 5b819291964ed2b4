"""Ahead-of-time export of the fused frame.

Port of ``mgnet_tpu/export/aot.py``: the fused frame (model + panoptic
fusion + DGC depth, weights baked in) traced once at static shapes into
one portable artifact that runs without Python model code. In JAX that is
``jax.export`` (StableHLO, compiled by XLA or a C++ PJRT runtime); here it
is ``torch.export`` (an ``ExportedProgram`` of ATen ops, the portable
``.pt2``) and AOTInductor, which compiles it into a shared library inside a
package that ``torch._inductor.aoti_load_package`` or the C++ runner
(``export/csrc/aoti_runner.cpp``) loads.

The hand-written ``center_argmin`` kernel stays opaque in both: the frame
reaches it as the custom op ``mgnet::center_argmin``, which Inductor calls
through its proxy executor (the registered CUDA kernel in Python; the
``TORCH_LIBRARY`` registration of ``export/csrc/mgnet_ops.cpp`` in the
runner) and never replaces by generated code. Everything around it is
Inductor's generated code, as it is XLA's in JAX.

An ``ExportedProgram`` is traced on the device of its example inputs, the
frame's own: a card's package is exported from a frame on the card.
"""

from __future__ import annotations

import copy
import io
import os
import time
from pathlib import Path
from typing import Callable, Tuple

import torch
from torch import nn

from mgnet_tpu_torch.inference.fused import (
    build_fused_inference,
    fusion_kwargs,
)
from mgnet_tpu_torch.models import as_float64_
from mgnet_tpu_torch.ops import _build
# also registers mgnet::center_argmin, which the traced frame calls
from mgnet_tpu_torch.ops.center_argmin import center_argmin_reference
from mgnet_tpu_torch.postprocessing.panoptic import panoptic_fusion

__all__ = ["export_fused_inference", "save_exported", "load_exported",
           "load_program", "package_path", "compare_exact",
           "compare_outputs", "shares", "float64_shares", "BarsMissed",
           "fnv1a64", "BARS", "INDUCTOR_NUMERICS"]

# The exported frame against the live one, by the model's compute dtype:
# (the share of pixels on which the labels agree, at least; the continuous
# outputs' abs and rel tolerance where panoptic's classes agree, since the
# depth filters read them; the share of their values that must lie within
# it), as compare_outputs holds them. Inductor's fused code rounds
# differently from eager (another order of a fused reduction, a
# transcendental a float32 ulp apart), and weights that are seeded, or
# trained a few steps, on the ImageNet backbone amplify such a difference
# on a few pixels. In float32 the labels and tolerance are
# tests/test_torch_fused.py's bars against the JAX frame (which the CPU
# tests hold on every value, at narrow seeded heads); the share of values
# is the one found on the H100 at 512x1024 with the ImageNet backbone and
# seeded heads. In bfloat16 a one-ulp rounding moves by 2**-8, and the bar
# is the one found on the H100 for the 1024x2048 frame with heads seeded
# by N(0, 1/fan_in); heads seeded by the JAX package's rule, and the
# trainer's model_final, miss it (an open fault: PERF.md, ROADMAP).
BARS = {torch.float32: (0.999, 1e-4, 1e-4, 0.98),
        torch.bfloat16: (0.97, 1e-2, 2e-2, 0.99)}


# The Inductor configs of the package that bear on its numbers:
# round to bfloat16 where eager autocast does; otherwise Inductor keeps a
# fused kernel's intermediates in float32, and the bfloat16 package drifts
# further from the eager frame
INDUCTOR_NUMERICS = {"emulate_precision_casts": True}


class _Forward(nn.Module):
    """The frame's ``forward`` for ``torch.export``, which calls the module:
    past ``FusedFrame.__call__``, which converts its inputs and enters
    inference mode."""

    def __init__(self, frame):
        super().__init__()
        self.frame = frame

    def forward(self, image, camera_matrix=None, camera_height=None):
        return self.frame.forward(image, camera_matrix, camera_height)


def export_fused_inference(
    frame,
    input_shape: Tuple[int, int, int, int] = (1, 1024, 2048, 3),
    with_camera: bool = True,
):
    """Trace ``frame`` (a ``FusedFrame``) with its weights at static
    shapes: an image [B, H, W, 3] f32 and, ``with_camera``, a camera
    matrix [B, 3, 3] and height [B] f32, on the frame's device.

    Returns (torch.export.ExportedProgram, its serialized bytes).
    """
    b = input_shape[0]
    device = frame.device
    args = (torch.zeros(input_shape, dtype=torch.float32, device=device),)
    if with_camera:
        args += (torch.eye(3, device=device).expand(b, 3, 3).contiguous(),
                 torch.ones(b, device=device))
    with torch.no_grad():
        exported = torch.export.export(_Forward(frame), args, strict=False)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return exported, buf.getvalue()


def package_path(path) -> Path:
    """The AOTInductor package written beside the exported program at
    ``path``: ``model.pt2`` -> ``model.aoti.pt2``."""
    path = Path(path)
    return path.with_name(path.stem + ".aoti.pt2")


def output_keys(exported) -> list:
    """The frame's output keys in the order of the package's flat
    outputs."""
    return list(exported.call_spec.out_spec.context)


def save_exported(path, exported, blob: bytes) -> Tuple[Path, float]:
    """Write the exported program's bytes to ``path`` (the portable
    artifact, ``torch.export.load`` reads it) and compile it with
    AOTInductor into the package ``package_path(path)``, whose metadata
    names the outputs in order (``output_keys``, comma-separated).

    Returns (the package's path, the compile's seconds).
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(blob)
    pkg = package_path(path)
    t0 = time.perf_counter()
    torch._inductor.aoti_compile_and_package(
        exported, package_path=os.fspath(pkg),
        inductor_configs={
            "aot_inductor.metadata": {
                "output_keys": ",".join(output_keys(exported))},
            **INDUCTOR_NUMERICS,
            # the g++ on PATH, which also builds the C++ runner, rather
            # than $CXX: Inductor links the package's library with
            # -fopenmp, which a $CXX without libgomp refuses
            "cpp.cxx": (None, _build._gxx())})
    return pkg, time.perf_counter() - t0


def load_exported(path) -> Callable:
    """Load the AOTInductor package that ``save_exported(path, ...)`` wrote
    beside ``path``: a callable that takes the exported signature's
    tensors and returns the frame's dict."""
    return torch._inductor.aoti_load_package(os.fspath(package_path(path)))


def load_program(path) -> Callable:
    """The ``ExportedProgram`` that ``save_exported`` wrote at ``path`` as
    a callable: the same ATen ops as the live frame, run eagerly, without
    gradients, returning the frame's dict."""
    module = torch.export.load(os.fspath(path)).module()

    def run(*args):
        with torch.no_grad():
            return module(*args)

    return run


def compare_exact(got, want) -> dict:
    """Hold ``got`` to ``want`` (dicts of tensors) bit for bit: the same
    keys, shapes and dtypes, and every value equal (NaN where ``want`` has
    NaN). Raises AssertionError naming each key that differs, with its
    share of differing values and its max |diff|.

    Returns {key: the number of values compared}."""
    if set(got) != set(want):
        raise AssertionError(f"keys {sorted(got)} != {sorted(want)}")
    failed, counted = [], {}
    for key in sorted(want):
        g, w = got[key], want[key]
        if (g.shape, g.dtype) != (w.shape, w.dtype):
            failed.append(f"{key}: {g.shape} {g.dtype} != {w.shape} "
                          f"{w.dtype}")
            continue
        same = g == w
        if g.is_floating_point():
            same |= torch.isnan(g) & torch.isnan(w)
        if not bool(same.all()):
            diff = (g.double() - w.double()).abs()
            failed.append(f"{key}: {float((~same).double().mean()):.6g} of "
                          f"the values differ, max |diff| "
                          f"{float(diff.nan_to_num(float('inf')).max()):.6g}")
        counted[key] = w.numel()
    if failed:
        raise AssertionError("; ".join(failed))
    return counted


class BarsMissed(AssertionError):
    """The bars that ``compare_outputs`` found missed: ``missed`` maps each
    bar's name (a label's, or an output key) to the share found (None for
    NaN at other pixels), ``found`` is its whole result."""

    def __init__(self, message: str, missed: dict, found: dict):
        super().__init__(message)
        self.missed, self.found = missed, found


def compare_outputs(got, want, statics, agree: float, atol: float,
                    rtol: float, within: float = 1.0):
    """Hold the frame outputs ``got`` to ``want`` (dicts of tensors) of a
    frame with ``statics``: the same keys, shapes and dtypes; sem_seg, and
    panoptic's classes (id // label_divisor), equal on at least ``agree``
    of the pixels, and panoptic equal, on as many, to the plain fusion of
    ``got``'s own sem_seg, center and offset (the clustering runs on
    ``center_argmin_reference``); of every other output, at least
    ``within`` of the values within ``atol`` + ``rtol`` * |want| where the
    classes agree (everywhere without panoptic), with NaN where ``want``
    has NaN. Raises BarsMissed (an AssertionError) naming every bar
    missed.

    Panoptic is held to the fusion of its own heads, not to ``want``'s:
    where a heatmap is flat at its peak (a saturated sigmoid), a center
    one ulp apart moves the NMS peaks and the instance ids, though heads
    and classes agree.

    Returns {"agree": {name: share}, "within": {key: share}, "max_abs":
    {key: max |got - want|}} over those pixels."""
    if set(got) != set(want):
        raise AssertionError(f"keys {sorted(got)} != {sorted(want)}")
    for key in want:
        g, w = got[key], want[key]
        if (g.shape, g.dtype) != (w.shape, w.dtype):
            raise AssertionError(f"{key}: {g.shape} {g.dtype} != "
                                 f"{w.shape} {w.dtype}")
    fused = None
    if "panoptic" in want:
        with torch.inference_mode():
            fused = panoptic_fusion(got["sem_seg"], got["center"],
                                    got["offset"], **fusion_kwargs(statics),
                                    argmin=center_argmin_reference).cpu()
    got = {k: v.cpu() for k, v in got.items()}
    want = {k: v.cpu() for k, v in want.items()}
    found = {"agree": {}, "within": {}, "max_abs": {}}
    failed, missed = [], {}
    if fused is not None:
        div = statics.label_divisor
        g_cls = torch.div(got["panoptic"], div, rounding_mode="floor")
        w_cls = torch.div(want["panoptic"], div, rounding_mode="floor")
        same = g_cls == w_cls
        for name, eq in (("sem_seg", got["sem_seg"] == want["sem_seg"]),
                         ("panoptic classes", same),
                         ("panoptic fusion", got["panoptic"] == fused)):
            found["agree"][name] = float(eq.double().mean())
            if found["agree"][name] < agree:
                failed.append(f"{name} equal on {found['agree'][name]:.6f} "
                              f"of the pixels < {agree}")
                missed[name] = found["agree"][name]
    else:
        same = torch.ones(want["depth"].shape, dtype=torch.bool)
    for key in sorted(set(want) - {"sem_seg", "panoptic"}):
        g, w = got[key], want[key]
        m = same[..., None].expand_as(g) if g.dim() > same.dim() else same
        g, w = g[m], w[m]
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            failed.append(f"{key} NaN at other pixels")
            missed[f"{key} NaN"] = None
        ok = ~torch.isnan(w)
        err = (g[ok] - w[ok]).abs()
        close = err <= atol + rtol * w[ok].abs()
        found["max_abs"][key] = float(err.max()) if err.numel() else 0.0
        found["within"][key] = (float(close.double().mean())
                                if close.numel() else 1.0)
        if found["within"][key] < within:
            failed.append(f"{key} {found['within'][key]:.6f} of the values "
                          f"within {atol} + {rtol} * |want| < {within}")
            missed[key] = found["within"][key]
    if failed:
        raise BarsMissed(f"{'; '.join(failed)} (found {found})", missed,
                         found)
    return found


def shares(got, want, statics, atol: float, rtol: float) -> dict:
    """``compare_outputs``' findings without its bars: {"agree": the
    labels' agreement, "within": each continuous output's share within
    ``atol`` + ``rtol`` * |want|, "max_abs": ...}. Holds a frame against
    another frame, such as the model's float64 reference."""
    try:
        return compare_outputs(got, want, statics, 0.0, atol, rtol, 0.0)
    except BarsMissed as e:  # NaN at other pixels: the shares stand
        return e.found


def float64_shares(frame, outputs: dict, inputs, atol: float,
                   rtol: float) -> dict:
    """Each of ``outputs`` ({name: outputs of ``frame``, or of code built
    from it, on ``inputs``}) held by ``shares`` to the same frame with a
    float64 copy of its model (``models.as_float64_``) on the same
    inputs: {name: {"agree": ..., "within": ...}}. Tells how far two
    frames that disagree each lie from the exact answer."""
    frame64 = build_fused_inference(
        as_float64_(copy.deepcopy(frame.model)), frame.statics,
        frame.pixel_mean, frame.pixel_std, frame.with_panoptic,
        frame.with_depth, frame.return_point_cloud, frame.device)
    ref = frame64(*inputs)
    return {name: {k: v for k, v in shares(out, ref, frame.statics, atol,
                                           rtol).items() if k != "max_abs"}
            for name, out in outputs.items()}


def fnv1a64(t: torch.Tensor) -> int:
    """FNV-1a (64 bits) of the tensor's bytes in C order: the checksum that
    the C++ runner prints of the panoptic output."""
    h = 0xCBF29CE484222325
    for byte in t.detach().contiguous().cpu().numpy().tobytes():
        h = ((h ^ byte) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h
