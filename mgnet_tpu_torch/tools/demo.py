"""Image and video demo.

    python -m mgnet_tpu_torch.tools.demo --config-file FILE --output DIR
        [--input IMG ...] [--video-input VIDEO] [--weights W]
        [--calib CAMERA.json] [--save-pcl] [--device cuda] [KEY VALUE ...]

The counterpart of ``tools/demo.py``: the ``Predictor`` on ``--device``
runs each input image (a PNG), and the ``Visualizer`` writes
``<stem>_panoptic.png`` (the panoptic overlay), ``<stem>_instances.png``
(offset directions weighted by the center heatmap) and
``<stem>_depth.png``; with ``--save-pcl`` and a camera (``--calib``, a
Cityscapes camera JSON) the point cloud goes to ``<stem>_points.npy``.
``--video-input`` runs every frame of a video and writes the panoptic
overlay above the depth to ``demo_output.mp4``; reading and writing video
needs OpenCV, which the rest of the port does without.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

from mgnet_tpu_torch.config import load_config
from mgnet_tpu_torch.data import (
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    MetadataCatalog,
    build_meta,
    read_image,
)
from mgnet_tpu_torch.inference import Predictor
from mgnet_tpu_torch.inference.visualizer import Visualizer

__all__ = ["main", "parse_args"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--input", nargs="+", default=[], help="image files")
    p.add_argument("--video-input", default="",
                   help="video file, run frame by frame")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--weights", default="")
    p.add_argument("--calib", default="",
                   help="camera calibration JSON (Cityscapes format)")
    p.add_argument("--save-pcl", action="store_true",
                   help="save the xyz point cloud as .npy")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _video(predictor, vis, path: str, output: str) -> int:
    """Every frame of ``path``: the panoptic overlay above the depth, into
    ``output/demo_output.mp4``. Returns the frame count."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "--video-input needs OpenCV (the cv2 module) to read and write "
            "video, and it is not installed") from e
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 17.0
    writer = None
    n = 0
    try:
        while True:
            ok, frame_bgr = cap.read()
            if not ok:
                break
            frame = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
            out = predictor(frame)
            pan_rgb = vis.panoptic_rgb(out["panoptic"], frame)
            depth_rgb = (vis.depth_rgb(out["depth"]) if "depth" in out
                         else np.zeros_like(pan_rgb))
            combined = np.concatenate([pan_rgb, depth_rgb], axis=0)
            if writer is None:
                writer = cv2.VideoWriter(
                    os.path.join(output, "demo_output.mp4"),
                    cv2.VideoWriter_fourcc(*"mp4v"), fps,
                    (combined.shape[1], combined.shape[0]))
            writer.write(cv2.cvtColor(combined, cv2.COLOR_RGB2BGR))
            n += 1
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    return n


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    cfg = load_config(args.config_file, args.opts)
    if args.weights:
        cfg.MODEL.WEIGHTS = args.weights
    calib = None
    if args.calib:
        with open(args.calib) as f:
            calib = json.load(f)
    # metadata for the statics and colours, without a dataset registry
    meta = MetadataCatalog.get("demo").set(
        **build_meta(CITYSCAPES_SCENE_SEG_CATEGORIES))
    predictor = Predictor(cfg, calibration_info=calib, dataset_name="demo",
                          device=args.device)
    vis = Visualizer(meta)

    os.makedirs(args.output, exist_ok=True)
    for path in args.input:
        img = read_image(path)
        out = predictor(img)
        stem = os.path.join(args.output,
                            os.path.splitext(os.path.basename(path))[0])
        vis.save_panoptic(f"{stem}_panoptic.png", img, out["panoptic"])
        if "center" in out and "offset" in out:
            vis.save_instance_heatmaps(f"{stem}_instances.png",
                                       out["center"], out["offset"])
        if "depth" in out:
            vis.save_depth(f"{stem}_depth.png", out["depth"])
        if args.save_pcl and "points" in out:
            np.save(f"{stem}_points.npy", out["points"])
        print(f"{path} -> {stem}_*.png")

    if args.video_input:
        n = _video(predictor, vis, args.video_input, args.output)
        print(f"{args.video_input}: {n} frames -> "
              f"{args.output}/demo_output.mp4")


if __name__ == "__main__":
    main(sys.argv[1:])
