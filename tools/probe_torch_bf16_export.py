#!/usr/bin/env python3
"""Where the bfloat16 AOTInductor package of the fused frame parts from
the eager frame, held against the model's float64 reference.

    python3 tools/probe_torch_bf16_export.py [--height 256] [--width 512]
        [--train-steps 6 | --weights MODEL_FINAL] [--no-package]
        [--device cuda]

The model is the Fine YAML's in bfloat16: the ImageNet backbone
(``weights/imagenet_weights.npz``), the rest drawn from the seed by the
JAX package's init rule; ``--train-steps`` bf16 steps of the Fine recipe
on the seeded synthetic batch (4 of 512x1024) then stand in for the
trainer's ``model_final`` (0 keeps the seeded heads of chip_smoke.py's
export phase). ``--weights`` loads a trained ``model_final`` directory
(or an npz graft, as ``tools.export_inference --weights``) instead, such
as the trainer's in chip_smoke.py, on which the package misses
``BARS[bfloat16]``. On the frame's verification inputs
(``tools.export_inference.verify_inputs``) it prints, as one JSON line
each:

1. ``frame``: the eager bfloat16 frame and the AOTInductor package
   (``export.save_exported``, the configs it passes) against a float64
   copy of the model (``models.as_float64_``) on the same inputs, and the
   package against eager, each by ``export.compare_outputs`` at
   ``BARS[bfloat16]``: the labels' agreement and the share of center,
   offset, depth and points within 1e-2 + 2e-2 * |reference|;
2. ``stage``: the model's stages compiled by ``torch.compile`` (Inductor,
   the package's configs): the backbone, the backbone with the GCM, and
   each head on the eager features, each against its eager run and both
   against float64, by the same share of values; and the same stages
   with Inductor's ``layout_optimization`` off, and eager in
   channels-last against eager in NCHW;
3. ``compiled-frame``: the whole frame through ``torch.compile`` with the
   package's configs, with ``layout_optimization`` off and with
   ``freezing`` (the weights folded as constants, as in the package) on,
   against eager and against float64 (``--no-stages`` skips 2 and 3).

The first stage whose share against eager drops names the place. Runs on
the card (``--device cpu`` for a rehearsal at a small size).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mgnet_tpu_torch.config import (  # noqa: E402
    apply_cityscapes_fine,
    get_default_config,
)
from mgnet_tpu_torch.data import (  # noqa: E402
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    Metadata,
    build_meta,
    synthetic_train_batch,
)
from mgnet_tpu_torch.export import (  # noqa: E402
    BARS,
    INDUCTOR_NUMERICS,
    export_fused_inference,
    load_exported,
    save_exported,
    shares,
)
from mgnet_tpu_torch.inference import (  # noqa: E402
    build_fused_inference,
    statics_from_meta,
)
from mgnet_tpu_torch.models import (  # noqa: E402
    as_float64_,
    build_model,
    init_random_,
)
from mgnet_tpu_torch.tools.export_inference import verify_inputs  # noqa: E402
from mgnet_tpu_torch.train import (  # noqa: E402
    create_train_state,
    make_train_step,
)
from mgnet_tpu_torch.train.step import normalize_images  # noqa: E402
from mgnet_tpu_torch.utils import load_jax_params  # noqa: E402
from mgnet_tpu_torch.utils.weights import load_eval_weights  # noqa: E402

SEED = 0
ATOL, RTOL = BARS[torch.bfloat16][1:3]
# the suspects, as Inductor configs over the package's own
SUSPECTS = {"package-configs": {},
            "layout_optimization-off": {"layout_optimization": False},
            "freezing-on": {"freezing": True}}
# freezing folds the weights as constants, which a stage's compile sees
# only through the whole frame
STAGE_SUSPECTS = ("package-configs", "layout_optimization-off")


def log(*args):
    print(*args, flush=True)


def frame_shares(got, want, statics) -> dict:
    """``export.shares`` at BARS[bfloat16]'s tolerance, rounded."""
    found = shares(got, want, statics, ATOL, RTOL)
    return {k: {n: round(v, 6) for n, v in found[k].items()}
            for k in ("agree", "within")}


def within(got, want) -> float:
    """Share of ``got``'s values within ATOL + RTOL * |want|."""
    g, w = got.double().flatten(), want.double().flatten()
    return round(float(((g - w).abs() <= ATOL + RTOL * w.abs())
                       .double().mean()), 6)


def flat(out):
    """A stage's outputs as a flat dict of tensors."""
    if isinstance(out, dict):
        return out
    if isinstance(out, (tuple, list)):
        return {str(i): t for i, t in enumerate(out)}
    return {"0": out}


def model_for(cfg, device, train_steps: int, weights: str = ""):
    """The eval model: ImageNet backbone, seeded rest, after
    ``train_steps`` bf16 Fine steps on the seeded synthetic batch; or,
    with ``weights``, the seeded model with those weights loaded."""
    if weights:
        model = build_model(cfg, device="cpu")
        init_random_(model, torch.Generator().manual_seed(SEED))
        load_eval_weights(model, weights)
        log(f"[probe] loaded {weights}")
        return model.to(device).eval()
    train = build_model(cfg, device="cpu", for_training=True)
    init_random_(train, torch.Generator().manual_seed(SEED))
    npz = np.load(ROOT / "weights" / "imagenet_weights.npz")
    for prefix, module in (("backbone/", train.backbone),
                           ("pose_net/encoder/", train.pose_net.encoder)):
        module.load_state_dict(load_jax_params(
            {k[len(prefix):]: npz[k] for k in npz.files
             if k.startswith(prefix)}, module))
    if train_steps:
        train.to(device)
        state = create_train_state(cfg, train)
        batch = synthetic_train_batch(4, 512, 1024, num_classes=20,
                                      last_stuff_id=10, seed=SEED)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in batch.items()}
        step = make_train_step(cfg)
        for _ in range(train_steps):
            _, m = step(state, batch)
        log(f"[probe] {train_steps} bf16 Fine steps: loss_total "
            f"{float(m['loss_total']):.4f}")
    model = build_model(cfg, device="cpu")
    src = train.state_dict()
    model.load_state_dict({k: src[k].cpu() for k in model.state_dict()})
    return model.to(device).eval()


def stage_fns(model) -> dict:
    """The stages of the frame's network: name -> the module call, on
    NCHW images (backbone, backbone+gcm) or the features (each head)."""
    return {"backbone": model.backbone,
            "backbone+gcm": model._features,
            "sem_seg_head": model.sem_seg_head,
            "ins_embed_head": model.ins_embed_head,
            "depth_head": model.depth_head}


def run(model, fn, arg):
    """``fn(arg)`` under the model's autocast, without gradients."""
    t = arg if torch.is_tensor(arg) else arg["res5"]
    with torch.inference_mode(), model._autocast(t.device.type):
        return fn(arg)


def convert(arg, fn):
    return fn(arg) if torch.is_tensor(arg) else {k: fn(v)
                                                 for k, v in arg.items()}


def compiled(fn, options):
    torch._dynamo.reset()
    return torch.compile(fn, backend="inductor",
                         options={**INDUCTOR_NUMERICS, **options})


def probe_stages(model, model64, x):
    """Each stage compiled under each suspect's configs, and eager in
    channels-last, against eager NCHW and against float64, on the same
    input: the images for the backbone, the eager features for a head."""
    nchw = x.permute(0, 3, 1, 2)
    feats = run(model, model._features, nchw)
    cl = copy.deepcopy(model).to(memory_format=torch.channels_last)
    fns, fns64, fns_cl = stage_fns(model), stage_fns(model64), stage_fns(cl)
    for name, fn in fns.items():
        arg = nchw if name.startswith("backbone") else feats
        want = flat(run(model, fn, arg))
        f64 = flat(run(model64, fns64[name],
                       convert(arg, lambda t: t.double())))
        runs = {"eager-channels_last": flat(run(cl, fns_cl[name], convert(
            arg, lambda t: t.contiguous(memory_format=torch.channels_last))))}
        seconds = {}
        for tag in STAGE_SUSPECTS:
            t0 = time.perf_counter()
            runs[f"compiled-{tag}"] = flat(run(
                model, compiled(fn, SUSPECTS[tag]), arg))
            seconds[tag] = round(time.perf_counter() - t0, 1)
        row = {"stage": name, "compile_s": seconds,
               "eager-vs-f64": {k: within(want[k], f64[k]) for k in want}}
        for tag, got in runs.items():
            row[f"{tag}-vs-eager"] = {k: within(got[k], want[k])
                                      for k in want}
            row[f"{tag}-vs-f64"] = {k: within(got[k], f64[k]) for k in want}
        log("stage " + json.dumps(row))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--train-steps", type=int, default=6)
    p.add_argument("--weights", default="",
                   help="a model_final directory (or npz) in place of the "
                        "seeded model and --train-steps")
    p.add_argument("--no-package", action="store_true",
                   help="skip the AOTInductor package")
    p.add_argument("--no-stages", action="store_true",
                   help="skip the stages and the compiled frames")
    p.add_argument("--output", default=str(ROOT / "output" / "probe_bf16"))
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="config overrides (KEY VALUE ...)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe: --device cuda but no card is visible")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = apply_cityscapes_fine(get_default_config())
    cfg.MODEL.COMPUTE_DTYPE = "bfloat16"
    cfg.merge_from_list(args.opts)
    t0 = time.perf_counter()
    model = model_for(cfg, device, args.train_steps, args.weights)
    model64 = as_float64_(copy.deepcopy(model))
    meta = Metadata(name="probe").set(
        **build_meta(CITYSCAPES_SCENE_SEG_CATEGORIES))
    statics = statics_from_meta(cfg, meta)
    frames = {name: build_fused_inference(
        m, statics, tuple(cfg.MODEL.PIXEL_MEAN), tuple(cfg.MODEL.PIXEL_STD),
        device=device) for name, m in (("eager", model), ("f64", model64))}
    inputs = verify_inputs(args.height, args.width, device)
    out = {name: f(*inputs) for name, f in frames.items()}
    log(f"[probe] {args.height}x{args.width}, model ready in "
        f"{time.perf_counter() - t0:.1f} s")
    row = {"eager-vs-f64": frame_shares(out["eager"], out["f64"], statics)}
    if not args.no_package:
        exported, blob = export_fused_inference(
            frames["eager"], (1, args.height, args.width, 3))
        t0 = time.perf_counter()
        save_exported(Path(args.output) / "frame.pt2", exported, blob)
        package = load_exported(Path(args.output) / "frame.pt2")
        got = package(*inputs)
        row["aoti_s"] = round(time.perf_counter() - t0, 1)
        row["package-vs-f64"] = frame_shares(got, out["f64"], statics)
        row["package-vs-eager"] = frame_shares(got, out["eager"], statics)
    log("frame " + json.dumps(row))

    if args.no_stages:
        return 0
    x = normalize_images(inputs[0], cfg.MODEL.PIXEL_MEAN,
                         cfg.MODEL.PIXEL_STD)
    probe_stages(model, model64, x)

    frame = frames["eager"]
    for tag, options in SUSPECTS.items():
        t0 = time.perf_counter()
        c = compiled(frame.forward, options)
        with torch.inference_mode():
            got = c(*inputs)
        log("compiled-frame " + json.dumps({
            "suspect": tag, "compile_s": round(time.perf_counter() - t0, 1),
            "vs-eager": frame_shares(got, out["eager"], statics),
            "vs-f64": frame_shares(got, out["f64"], statics)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
