"""Export the fused frame to an ahead-of-time artifact.

    python -m mgnet_tpu_torch.tools.export_inference --config-file FILE
        --output model.pt2 [--weights W] [--height 1024] [--width 2048]
        [--verify] [--device cuda] [KEY VALUE ...]

The counterpart of ``tools/export_inference.py``: one artifact holds the
whole frame (model + panoptic fusion + DGC depth) with the weights baked
in. The model of the config is built on ``--device`` from ``cfg.SEED``
with ``--weights`` (or ``MODEL.WEIGHTS``) loaded by ``load_eval_weights``:
a ``model_final`` directory, or an npz grafted where name and shape match
(``.npz`` may be left out); a path that does not exist leaves the seeded
weights, with a warning, as the JAX tool does. The frame is exported at
[1, H, W, 3] with a camera (``export.export_fused_inference``) and written
as the ``ExportedProgram`` ``--output`` plus the AOTInductor package
beside it (``model.aoti.pt2``), which ``export.load_exported`` and the C++
runner (``export/csrc/aoti_runner.cpp``) load.

``--verify`` runs the live frame on a seeded image with a Cityscapes camera
on the same device, then holds to it, in this order: the reloaded
``ExportedProgram`` bit for bit on every key (the same ATen ops, as the
JAX tool holds its artifact to the live jit, ``tools/export_inference.py:
112-136``), and the AOTInductor package, which is other code, at
``export.BARS`` of the model's compute dtype. It prints both results and
raises at the first that fails.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from mgnet_tpu_torch.config import load_config
from mgnet_tpu_torch.data import (
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    Metadata,
    build_meta,
)
from mgnet_tpu_torch.export import (
    BARS,
    compare_exact,
    compare_outputs,
    export_fused_inference,
    load_exported,
    load_program,
    save_exported,
)
from mgnet_tpu_torch.inference import build_fused_inference, statics_from_meta
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.utils.weights import load_eval_weights

__all__ = ["main", "parse_args", "verify_inputs"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--weights", default="")
    p.add_argument("--output", required=True,
                   help="the ExportedProgram (.pt2); the AOTInductor "
                        "package goes beside it")
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--verify", action="store_true",
                   help="after export: hold the reloaded ExportedProgram "
                        "to the live frame on --device bit for bit, then "
                        "the package at export.BARS")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def verify_inputs(height: int, width: int, device):
    """The JAX tool's verification inputs: a seeded image [1, H, W, 3]
    f32, a Cityscapes camera matrix [1, 3, 3] centred on the image and a
    height [1]."""
    rng = np.random.RandomState(0)
    image = torch.as_tensor(rng.randint(0, 255, (1, height, width, 3)),
                            dtype=torch.float32, device=device)
    K = torch.tensor([[[2262.52, 0, (width - 1) / 2],
                       [0, 2265.3, (height - 1) / 2],
                       [0, 0, 1]]], dtype=torch.float32, device=device)
    return image, K, torch.tensor([1.22], device=device)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    cfg = load_config(args.config_file, args.opts)
    device = torch.device(args.device)
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(cfg.SEED))
    weights = args.weights or cfg.MODEL.WEIGHTS
    if weights and not os.path.exists(weights):
        if os.path.isfile(weights + ".npz"):
            weights += ".npz"
        else:
            print(f"WARNING: weights path {weights} not found; using the "
                  f"seeded weights")
            weights = ""
    if weights:
        load_eval_weights(model, weights)
        print(f"Loaded {weights}")
    else:
        print("WARNING: exporting with seeded weights (no checkpoint given)")
    model.to(device).eval()
    meta = Metadata(name="export").set(
        **build_meta(CITYSCAPES_SCENE_SEG_CATEGORIES))
    statics = statics_from_meta(cfg, meta)
    frame = build_fused_inference(
        model, statics, tuple(cfg.MODEL.PIXEL_MEAN),
        tuple(cfg.MODEL.PIXEL_STD), with_panoptic=cfg.WITH_PANOPTIC,
        with_depth=cfg.WITH_DEPTH, device=device)
    exported, blob = export_fused_inference(
        frame, input_shape=(1, args.height, args.width, 3))
    pkg, seconds = save_exported(args.output, exported, blob)
    print(f"Wrote {args.output} ({len(blob)} bytes) and {pkg} "
          f"({pkg.stat().st_size} bytes; AOTInductor {seconds:.1f} s)")

    if args.verify:
        inputs = verify_inputs(args.height, args.width, device)
        want = frame(*inputs)
        counted = compare_exact(load_program(args.output)(*inputs), want)
        print(f"EXACT OK on {device}: the ExportedProgram equals the live "
              f"frame bit for bit on every key ({sum(counted.values())} "
              f"values of {', '.join(counted)})")
        got = load_exported(args.output)(*inputs)
        bars = BARS[model.dtype]
        found = compare_outputs(got, want, statics, *bars)
        print(f"PARITY OK on {device}: the package matches the live frame "
              f"(labels on >= {bars[0]} of the pixels: {found['agree']}; "
              f">= {bars[3]} of the rest within {bars[1]} abs + {bars[2]} "
              f"rel: {found['within']}, max |diff| {found['max_abs']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
