"""Synthetic training data made from a seed (numpy, host side).

``synthetic_train_batch`` is a copy of
``mgnet_tpu/data/synthetic.py::synthetic_train_batch`` for the joint model
(both task branches always): random images with context frames shifted by
+-2 columns, a plausible pinhole camera, a full reprojection mask, and
panoptic targets of two thing instances on one stuff class per image.

``write_cityscapes_tree`` writes a small Cityscapes-layout panoptic tree to
disk, for the datasets' path through ``data/cityscapes.py``,
``data/mapper.py`` and ``data/loader.py``, and optionally a val split with
disparity ground truth for the evaluation.

``make_synthetic_cityscapes_raw`` and ``make_synthetic_kitti_raw`` are the
JAX package's raw trees (``mgnet_tpu/data/synthetic.py:85,138``) with the
same signatures, seeds and draw order, written through ``write_png``: the
runbook's inputs before conversion (instanceIds, not yet COCO-panoptic),
so that preparation, training and evaluation run without real data.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence, Tuple

import numpy as np

from mgnet_tpu_torch.data.image_io import write_png
from mgnet_tpu_torch.data.mapper import id2rgb
from mgnet_tpu_torch.data.target_generator import PanopticTargetGenerator

__all__ = ["make_synthetic_cityscapes_raw", "make_synthetic_kitti_raw",
           "synthetic_train_batch", "write_cityscapes_tree"]


def synthetic_train_batch(
    batch: int = 2,
    height: int = 64,
    width: int = 64,
    num_classes: int = 20,
    last_stuff_id: int = 10,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Random scene with two instances per image + plausible camera."""
    rng = np.random.RandomState(seed)
    out: Dict[str, np.ndarray] = {}

    def rand_img():
        return rng.randint(0, 255, (batch, height, width, 3)).astype(
            np.float32)

    out["image"] = rand_img()
    out["image_prev"] = np.roll(out["image"], 2, axis=2)
    out["image_next"] = np.roll(out["image"], -2, axis=2)
    out["image_orig"] = out["image"] / 255.0
    out["image_prev_orig"] = out["image_prev"] / 255.0
    out["image_next_orig"] = out["image_next"] / 255.0
    K = np.array(
        [[0.8 * width, 0, (width - 1) / 2],
         [0, 0.8 * width, (height - 1) / 2],
         [0, 0, 1]], np.float32,
    )
    out["camera_matrix"] = np.broadcast_to(K, (batch, 3, 3)).copy()
    out["reprojection_mask"] = np.ones((batch, height, width, 1), np.float32)
    out["camera_height"] = np.full((batch,), 1.65, np.float32)

    thing_ids = list(range(last_stuff_id + 1, num_classes))
    gen = PanopticTargetGenerator(
        ignore_label=255, thing_ids=thing_ids, sigma=8,
        small_instance_area=64, small_instance_weight=3,
    )
    keys = ("sem_seg", "center", "offset", "sem_seg_weights",
            "center_weights", "offset_weights")
    acc = {k: [] for k in keys}
    for _ in range(batch):
        pan = np.full((height, width), 1 * 1000, np.int32)
        segs = [dict(id=1000, category_id=1, iscrowd=0)]
        for i, cid in enumerate(rng.choice(thing_ids, 2)):
            y0 = rng.randint(0, height // 2)
            x0 = rng.randint(0, width // 2)
            pid = cid * 1000 + i + 1
            pan[y0:y0 + height // 3, x0:x0 + width // 3] = pid
            segs.append(dict(id=pid, category_id=int(cid), iscrowd=0))
        t = gen(pan, segs)
        t["center"] = t["center"][..., None]
        for k in keys:
            acc[k].append(t[k])
    out.update({k: np.stack(v) for k, v in acc.items()})
    return out


def _tree_frame(rng: np.random.Generator, h: int, w: int):
    """A frame of smooth colour gradients under noise, and its two sequence
    neighbours: the frame shifted by -/+ 8 columns."""
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, 3)
    base = np.stack([127 + 100 * np.sin(gx / (w / (3 + c)) + gy / h * 4
                                        + phase[c]) for c in range(3)], -1)
    img = np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(
        np.uint8)
    return img, np.roll(img, -8, axis=1), np.roll(img, 8, axis=1)


def _tree_panoptic(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Panoptic ids of road and sky with a person and two cars."""
    pan = np.full((h, w), 7000, np.int64)               # road
    pan[: h // 3] = 23000                                 # sky
    y0 = int(rng.integers(h // 3, h - h // 4))            # a person
    pan[y0:y0 + h // 5, w // 2 - w // 20:w // 2 + w // 20] = 24001
    for k in (1, 2):                 # a car in each half of the frame
        y0 = int(rng.integers(h // 3, h - h // 4))
        x0 = int(rng.integers((k - 1) * w // 2, k * w // 2 - w // 6))
        pan[y0:y0 + h // 6, x0:x0 + w // 6] = 26000 + k
    return pan


# the segments of every _tree_panoptic map (a car may hide the other)
_SEGMENTS = [{"id": i, "category_id": i // 1000, "iscrowd": 0}
             for i in (7000, 23000, 24001, 26001, 26002)]


def _camera(h: int, w: int, f: int) -> Dict:
    return {"intrinsic": {"fx": 1.1047 * w + f, "fy": 1.1061 * w,
                          "u0": 0.5356 * w, "v0": 0.5011 * h},
            "extrinsic": {"baseline": 0.209313, "z": 1.22}}


def _disparity(rng: np.random.Generator, pan: np.ndarray,
               camera: Dict) -> np.ndarray:
    """16-bit Cityscapes disparity (v = 256 * d + 1; 0 = no measurement)
    of a scene 60 m deep at the horizon and 4 m at the bottom row, with
    noise; 0 on sky."""
    h, w = pan.shape
    rows = np.linspace(60.0, 4.0, h)[:, None]
    depth = rows * np.exp(rng.normal(0, 0.05, (h, w)))
    disp = (camera["extrinsic"]["baseline"] * camera["intrinsic"]["fx"]
            / depth)
    v = np.round(disp * 256.0 + 1.0).astype(np.uint16)
    v[pan == 23000] = 0
    return v


def write_cityscapes_tree(root: str, frames: int, height: int, width: int,
                          seed: int = 0,
                          val_sizes: Sequence[Tuple[int, int]] = ()
                          ) -> Dict[str, np.ndarray]:
    """Write a Cityscapes-layout panoptic training tree under ``root`` (the
    layout ``register_all_cityscapes_scene_seg(root)`` reads as
    ``cityscapes_fine_scene_seg_train``): ``frames`` frames of height x
    width, each with its -/+1 sequence frames, a panoptic PNG of road and
    sky with a person and two cars, a camera JSON, and the panoptic JSON.
    As in Cityscapes, the sequence directory also holds each frame itself,
    so that the video-sequence split registered for pseudo-label
    generation (``pseudo_label_generation=True``) reads the same frames.
    With ``val_sizes``, also the split read as
    ``cityscapes_fine_scene_seg_val``: one frame of each (height, width),
    with its panoptic PNG, 16-bit disparity PNG and camera JSON, and the
    val panoptic JSON. Every PNG goes through ``write_png``. Returns
    {path: array written}."""
    city = "synth"
    base = os.path.join(root, "cityscapes")
    img_dir = os.path.join(base, "leftImg8bit", "train", city)
    seq_dir = os.path.join(base, "leftImg8bit_sequence", "train", city)
    cam_dir = os.path.join(base, "camera", "train", city)
    gt_dir = os.path.join(base, "gtFine", "cityscapes_panoptic_train")
    for d in (img_dir, seq_dir, cam_dir, gt_dir):
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    h, w = height, width
    written, anns = {}, []
    for f in range(frames):
        idx = 19 + 10 * f
        stem = f"{city}_000000_{idx:06d}"
        cur, prev, nxt = _tree_frame(rng, h, w)
        written[os.path.join(img_dir, f"{stem}_leftImg8bit.png")] = cur
        for i, a in ((idx - 1, prev), (idx, cur), (idx + 1, nxt)):
            written[os.path.join(
                seq_dir, f"{city}_000000_{i:06d}_leftImg8bit.png")] = a
        pan = _tree_panoptic(rng, h, w)
        written[os.path.join(gt_dir, f"{stem}_gtFine_panoptic.png")] = \
            id2rgb(pan)
        anns.append({"image_id": stem,
                     "file_name": f"{stem}_gtFine_panoptic.png",
                     "segments_info": _SEGMENTS})
        with open(os.path.join(cam_dir, f"{stem}_camera.json"), "w") as fh:
            json.dump(_camera(h, w, f), fh)
    with open(os.path.join(base, "gtFine",
                           "cityscapes_panoptic_train.json"), "w") as fh:
        json.dump({"annotations": anns, "categories": []}, fh)
    if val_sizes:
        _write_val(base, val_sizes, np.random.default_rng(seed + 1),
                   written)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda kv: write_png(*kv), written.items()))
    return written


def _write_val(base: str, sizes, rng: np.random.Generator,
               written: Dict[str, np.ndarray]) -> None:
    """The val split's frames into ``written`` and its JSONs to disk."""
    city = "synthval"
    dirs = {k: os.path.join(base, k, "val", city)
            for k in ("leftImg8bit", "camera", "disparity")}
    gt_dir = os.path.join(base, "gtFine", "cityscapes_panoptic_val")
    for d in (*dirs.values(), gt_dir):
        os.makedirs(d, exist_ok=True)
    anns = []
    for f, (h, w) in enumerate(sizes):
        stem = f"{city}_000000_{19 + 10 * f:06d}"
        written[os.path.join(dirs["leftImg8bit"],
                             f"{stem}_leftImg8bit.png")] = \
            _tree_frame(rng, h, w)[0]
        pan = _tree_panoptic(rng, h, w)
        written[os.path.join(gt_dir, f"{stem}_gtFine_panoptic.png")] = \
            id2rgb(pan)
        camera = _camera(h, w, f)
        written[os.path.join(dirs["disparity"], f"{stem}_disparity.png")] = \
            _disparity(rng, pan, camera)
        anns.append({"image_id": stem,
                     "file_name": f"{stem}_gtFine_panoptic.png",
                     "segments_info": _SEGMENTS})
        with open(os.path.join(dirs["camera"], f"{stem}_camera.json"),
                  "w") as fh:
            json.dump(camera, fh)
    with open(os.path.join(base, "gtFine", "cityscapes_panoptic_val.json"),
              "w") as fh:
        json.dump({"annotations": anns, "categories": []}, fh)


def make_synthetic_cityscapes_raw(root: str, split: str = "train",
                                  n_images: int = 2,
                                  height: int = 128, width: int = 256,
                                  seed: int = 7) -> None:
    """Write a raw synthetic Cityscapes tree under ``root/cityscapes``:
    per image, a random frame and its three sequence frames, a 16-bit
    instanceIds PNG (road, id 7, and one car, 26000 + n), a camera JSON and
    a random 16-bit disparity PNG; the input of
    ``tools.prepare_cityscapes``."""
    rng = np.random.RandomState(seed)
    city = "smokecity"
    dirs = {
        "img": f"{root}/cityscapes/leftImg8bit/{split}/{city}",
        "seq": f"{root}/cityscapes/leftImg8bit_sequence/{split}/{city}",
        "cam": f"{root}/cityscapes/camera/{split}/{city}",
        "disp": f"{root}/cityscapes/disparity/{split}/{city}",
        "raw_gt": f"{root}/cityscapes/gtFine/{split}/{city}",
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    for n in range(n_images):
        stem = f"{city}_{n:06d}_000010"
        img = rng.randint(0, 255, (height, width, 3), np.uint8)
        write_png(f"{dirs['img']}/{stem}_leftImg8bit.png", img)
        for i in (9, 10, 11):
            frame = f"{city}_{n:06d}_{i:06d}"
            write_png(f"{dirs['seq']}/{frame}_leftImg8bit.png",
                      rng.randint(0, 255, (height, width, 3), np.uint8))

        inst = np.full((height, width), 7, np.int32)
        y0 = 30 + 10 * n
        inst[y0:y0 + 40, 100:160] = 26000 + n
        write_png(f"{dirs['raw_gt']}/{stem}_gtFine_instanceIds.png",
                  inst.astype(np.uint16))

        with open(f"{dirs['cam']}/{stem}_camera.json", "w") as f:
            json.dump({
                "intrinsic": {"fx": 226.0, "fy": 226.0,
                              "u0": (width - 1) / 2,
                              "v0": (height - 1) / 2},
                "extrinsic": {"baseline": 0.222, "z": 1.22},
            }, f)
        disp = rng.randint(500, 20000, (height, width)).astype(np.uint16)
        write_png(f"{dirs['disp']}/{stem}_disparity.png", disp)


def make_synthetic_kitti_raw(root: str, n_frames: int = 7,
                             height: int = 96, width: int = 320,
                             seed: int = 11) -> None:
    """Write a raw synthetic KITTI-Eigen tree under ``root/kitti_eigen``:
    one drive of ``n_frames`` random frames (``<date>/<drive>/image_02/
    data``), a sparse 16-bit depth ground truth for the middle frame, the
    date's ``calib_cam_to_cam.txt`` and the eigen_zhou (interior frames)
    and eigen_test split lists."""
    rng = np.random.RandomState(seed)
    date = "2011_09_26"
    drive = f"{date}/{date}_drive_0001_sync"
    img_dir = f"{root}/kitti_eigen/{drive}/image_02/data"
    depth_dir = f"{root}/kitti_eigen/{drive}/proj_depth/groundtruth/image_02"
    splits = f"{root}/kitti_eigen/data_splits"
    for d in (img_dir, depth_dir, splits):
        os.makedirs(d, exist_ok=True)

    for i in range(n_frames):
        write_png(f"{img_dir}/{i:010d}.png",
                  rng.randint(0, 255, (height, width, 3), np.uint8))

    test_frame = n_frames // 2
    depth = (rng.uniform(2.0, 60.0, (height, width)) * 256).astype(np.uint16)
    depth[rng.rand(height, width) < 0.7] = 0  # sparse, like projected lidar
    write_png(f"{depth_dir}/{test_frame:010d}.png", depth)

    with open(f"{root}/kitti_eigen/{date}/calib_cam_to_cam.txt", "w") as f:
        f.write("calib_time: 2011\n")
        f.write(f"P_rect_02: {0.8 * width} 0.0 {(width - 1) / 2} 0.0 "
                f"0.0 {0.8 * width} {(height - 1) / 2} 0.0 "
                "0.0 0.0 1.0 0.0\n")

    with open(f"{splits}/eigen_zhou_files.txt", "w") as f:
        for i in range(1, n_frames - 1):
            f.write(f"{drive}/image_02/data/{i:010d}.png l\n")
    with open(f"{splits}/eigen_test_files.txt", "w") as f:
        f.write(f"{drive}/image_02/data/{test_frame:010d}.png l\n")
