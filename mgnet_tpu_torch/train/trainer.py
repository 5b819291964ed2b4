"""The training loop and the evaluation of a dataset.

Port of ``mgnet_tpu/train/trainer.py``, on one card per process: the model
and train state from the config (rank 0's broadcast to every rank), the
mapper named by ``INPUT.TRAIN_DATASET_MAPPER``, the threaded
``TrainLoader`` over ``DATASETS.TRAIN[0]`` (pinned batches, copied to the
card without blocking), ``make_train_step``, step checkpoints every
``SOLVER.CHECKPOINT_PERIOD`` iterations and at the end, ``Trainer.test``
every ``TEST.EVAL_PERIOD`` iterations (0: never), then the params-only
``model_final``.

Data-parallel over the ranks of a process group (``parallel``;
``tools/train_net.py --num-devices`` starts them): ``SOLVER.IMS_PER_BATCH``
is the global batch and must divide over ranks x ``GRAD_ACCUM_STEPS``;
each rank's loader maps only its part of each global batch, and the step
computes the global batch's step (``train/step.py``). Checkpoints,
``model_final`` and the metric log are written by rank 0 alone, each
followed by a barrier; every rank resumes from the same checkpoint.

As in the JAX trainer, every ``train()`` starts the loader at epoch 0: a
resumed run continues the step count, the optimizer and the schedule, not
the sample stream.

``evaluate_dataset`` runs the evaluator stack over ``DATASETS.TEST[0]``
with the JAX function's semantics: each process takes a strided shard;
samples are mapped on a pool of ``DATALOADER.NUM_WORKERS`` threads, padded
to one bucket of ``ceil(MIN_SIZE_TEST / div) * div`` x
``ceil(MAX_SIZE_TEST / div) * div`` and batched by (padded, valid,
original) shape, a tail padded to ``eval_pad_to``'s power of two by
repeating its last sample; per device batch, one eval step (or the
multi-scale + flip pass with ``TEST.MSC_FLIP_EVAL``), the outputs cropped
to the valid size and resized to the original one, the channel-first
argmax, one batched ``panoptic_fusion`` (one ``center_argmin`` launch),
``depth_postprocess``, and the compaction before the copy to the host (sem
uint8, panoptic int16, center and probabilities f16, depth
``min(depth, 6e4)`` in f16), upcast there; then the evaluators on each
real sample, on the host.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from mgnet_tpu_torch.data import (
    DatasetCatalog,
    MetadataCatalog,
    TrainLoader,
    read_image,
    rgb2id,
    to_device,
)
from mgnet_tpu_torch.evaluation import (
    DepthEvaluator,
    InstanceAPEvaluator,
    PanopticEvaluator,
    SemSegEvaluator,
)
from mgnet_tpu_torch.geometry.image import interpolate_bilinear
from mgnet_tpu_torch.inference.fused import fusion_kwargs, statics_from_meta
from mgnet_tpu_torch.inference.tta import multi_scale_flip_inference
from mgnet_tpu_torch.inference.visualizer import Visualizer
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.parallel import (
    data_parallel_size,
    process_count,
    process_index,
    replicate_,
    synchronize,
)
from mgnet_tpu_torch.postprocessing import (
    depth_postprocess,
    extract_instances,
    panoptic_fusion,
)
from mgnet_tpu_torch.train.state import create_train_state
from mgnet_tpu_torch.train.step import (
    make_eval_step,
    make_train_step,
    normalize_images,
)
from mgnet_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    load_params,
    save_params,
)
from mgnet_tpu_torch.utils.events import MetricLogger
from mgnet_tpu_torch.utils.loader import locate
from mgnet_tpu_torch.utils.profiling import peak_hbm_gb
from mgnet_tpu_torch.utils.weights import load_pretrained_npz

__all__ = ["Trainer", "eval_pad_to", "evaluate_dataset",
           "run_bucketed_eval", "to_host"]


class Trainer:
    """The training loop of one rank (of one card with one process).
    ``device`` defaults to the card; a rank of several passes its own
    (``parallel.initialize_distributed`` returns it); the tests pass
    ``"cpu"``."""

    def __init__(self, cfg, output_dir: Optional[str] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.output_dir = output_dir or cfg.OUTPUT_DIR
        os.makedirs(self.output_dir, exist_ok=True)

        batch = cfg.SOLVER.IMS_PER_BATCH
        accum = max(1, int(cfg.SOLVER.GRAD_ACCUM_STEPS))
        world = data_parallel_size(cfg)
        if batch % (world * accum):
            raise ValueError(f"IMS_PER_BATCH={batch} must divide over "
                             f"{world} ranks x {accum} GRAD_ACCUM_STEPS "
                             "micro-batches")
        # weights drawn on the CPU from the seed: the same on every device
        # (and rank 0's on every rank, as replicate_to_mesh places them)
        model = build_model(cfg, device="cpu", for_training=True)
        init_random_(model, torch.Generator().manual_seed(cfg.SEED))
        self.state = create_train_state(cfg, model.to(self.device))
        replicate_(self.state.params)
        self.train_step = make_train_step(cfg)
        self.ckpt = CheckpointManager(
            os.path.join(self.output_dir, "checkpoints"))
        self.logger = MetricLogger(self.output_dir)

        dataset_name = cfg.DATASETS.TRAIN[0]
        dataset = DatasetCatalog.get(dataset_name)
        mapper = locate(cfg.INPUT.TRAIN_DATASET_MAPPER)(
            cfg, dataset_name=dataset_name)
        self.loader = TrainLoader(
            dataset, mapper, batch_size=batch, seed=cfg.SEED,
            num_workers=cfg.DATALOADER.NUM_WORKERS,
            prefetch=cfg.DATALOADER.PREFETCH,
            divisibility=cfg.MODEL.SIZE_DIVISIBILITY,
            process_index=process_index(), process_count=world,
            pin_memory=self.device.type == "cuda", micro_batches=accum,
        )
        # the npz graft's {"matched", "skipped"}, once resume_or_load did one
        self.pretrained: Optional[Dict[str, int]] = None
        # host seconds of each iteration of the last train(): waiting on
        # the loader, writing a checkpoint and evaluating (0 where none),
        # and in all
        self.data_seconds: list = []
        self.save_seconds: list = []
        self.eval_seconds: list = []
        self.iter_seconds: list = []

    def resume_or_load(self, resume: bool = True):
        """Resume from the latest checkpoint when ``resume`` and one exists;
        else load MODEL.WEIGHTS: a ``model_final``-style directory grafted
        leaf by leaf where name and shape match (a mismatched leaf, such as
        KITTI's 19-class head against Fine's 20, keeps its fresh init;
        zero matches raise), or an npz of ImageNet weights (with or
        without the suffix; a configured but absent file raises)."""
        if resume:
            self.state, restored = self.ckpt.restore(self.state)
            if restored:
                print(f"Resumed from step {self.state.step}")
                return
        weights = self.cfg.MODEL.WEIGHTS
        if not weights:
            return
        if os.path.isdir(weights):
            src = load_params(weights)
            dst = self.state.params.state_dict()
            take = {k: v for k, v in src.items()
                    if k in dst and v.shape == dst[k].shape}
            skipped = sorted(set(src) - set(take))
            if not take:
                raise ValueError(
                    f"MODEL.WEIGHTS={weights!r} (checkpoint dir) matched "
                    "zero parameter leaves; wrong checkpoint or "
                    "incompatible model.")
            with torch.no_grad():
                for k, v in take.items():
                    dst[k].copy_(v)
            print(f"Loaded checkpoint weights from {weights}: {len(take)} "
                  "leaves" + (f", skipped {len(skipped)} (shape/name "
                              f"mismatch): {skipped[:6]}..." if skipped
                              else ""))
            return
        candidates = [weights]
        if not weights.endswith(".npz"):
            candidates.insert(0, weights + ".npz")
        path = next((p for p in candidates if os.path.exists(p)), None)
        if path is None:
            raise FileNotFoundError(
                f"MODEL.WEIGHTS={weights!r} not found (tried {candidates}); "
                "run tools/initialize_weights.sh or clear MODEL.WEIGHTS to "
                "train from scratch.")
        info = load_pretrained_npz(path, self.state.params)
        if info["matched"] == 0:
            raise ValueError(
                f"MODEL.WEIGHTS={path!r} matched zero parameter leaves "
                f"({info}); wrong file or incompatible model.")
        self.pretrained = info
        print(f"Loaded pretrained weights from {path}: {info}")

    def train(self):
        cfg = self.cfg
        max_iter = cfg.SOLVER.MAX_ITER
        start = self.state.step
        it = iter(self.loader)
        self.data_seconds, self.save_seconds = [], []
        self.eval_seconds, self.iter_seconds = [], []
        t_last = time.time()
        try:
            for i in range(start, max_iter):
                t0 = time.perf_counter()
                batch = to_device(next(it), self.device)
                self.data_seconds.append(time.perf_counter() - t0)
                self.state, metrics = self.train_step(self.state, batch)
                if (i + 1) % 20 == 0 or i == start:
                    host = {k: float(v) for k, v in metrics.items()}
                    host["iter_time"] = (time.time() - t_last) / 20
                    host["data_time"] = (sum(self.data_seconds[-20:])
                                         / len(self.data_seconds[-20:]))
                    t_last = time.time()
                    self.logger.log(i + 1, host)
                t1 = time.perf_counter()
                if ((i + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0
                        or i + 1 == max_iter):
                    self.ckpt.save(i + 1, self.state)  # rank 0 only
                    synchronize()
                self.save_seconds.append(time.perf_counter() - t1)
                eval_s = 0.0
                if (cfg.TEST.EVAL_PERIOD > 0
                        and (i + 1) % cfg.TEST.EVAL_PERIOD == 0):
                    t2 = time.perf_counter()
                    results = self.test()
                    self.logger.log(i + 1, {
                        f"eval/{grp}/{k}": v
                        for grp, d in results.items() for k, v in d.items()})
                    eval_s = time.perf_counter() - t2
                self.eval_seconds.append(eval_s)
                self.iter_seconds.append(time.perf_counter() - t0)
            peak = peak_hbm_gb(self.device)
            if peak is not None:
                self.logger.log(max_iter, {"peak_hbm_gb": peak})
            save_params(os.path.join(self.output_dir, "model_final"),
                        self.state.params)  # rank 0 only
            synchronize()
        finally:
            self.loader.close()

    def test(self) -> Dict[str, Dict[str, float]]:
        return evaluate_dataset(
            self.cfg, self.state.params.model,
            image_logger=self.logger, log_step=self.state.step,
            visualize_dir=(os.path.join(self.output_dir, "eval_vis")
                           if self.cfg.VISUALIZE_EVALUATION else None))


def run_bucketed_eval(prepared_iter, key_fn, batch_size, flush):
    """Shape-bucketed batching for the eval loop.

    Groups a stream of prepared samples by shape key, flushing a FULL
    batch (``batch_size``) as soon as one accumulates; after the stream
    ends, the one partial tail bucket per key flushes with ``final=True``
    so ``eval_pad_to`` can shrink its padding. Returns the number of
    samples seen.
    """
    buckets = defaultdict(list)
    n_items = 0
    for item in prepared_iter:
        key = key_fn(item)
        buckets[key].append(item)
        n_items += 1
        if len(buckets[key]) == batch_size:
            flush(key, buckets.pop(key))
    for key in list(buckets):
        flush(key, buckets.pop(key), final=True)
    return n_items


def eval_pad_to(n_items: int, batch_size: int, final: bool) -> int:
    """Batch size a bucket of ``n_items`` pads to: ``batch_size`` mid-stream;
    the FINAL partial bucket per shape key pads to the next power of two,
    clamped to ``batch_size`` (never a larger device batch than the one the
    user sized memory for)."""
    if not final:
        return batch_size
    return min(batch_size, 1 << max(0, n_items - 1).bit_length())


_UPCAST = {"sem": np.int32, "pan": np.int32, "center": np.float32,
           "probs": np.float32, "depth": np.float32}


def to_host(res: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Copy a device batch's compacted outputs to the host and upcast them:
    sem, pan to int32; center, probs, depth to float32."""
    return {k: v.cpu().numpy().astype(_UPCAST[k]) for k, v in res.items()}


def _make_tta_step(cfg):
    """(model, images [B, H, W, 3] raw RGB) -> the multi-scale + flip
    averages (semantic probabilities in 'sem_seg'), eval-mode BN, no
    gradients."""
    pixel_mean = tuple(cfg.MODEL.PIXEL_MEAN)
    pixel_std = tuple(cfg.MODEL.PIXEL_STD)

    @torch.no_grad()
    def tta_step(model, images):
        was_training = model.training
        model.eval()
        try:
            return multi_scale_flip_inference(
                model, normalize_images(images, pixel_mean, pixel_std),
                with_panoptic=cfg.WITH_PANOPTIC, with_depth=cfg.WITH_DEPTH)
        finally:
            model.train(was_training)

    return tta_step


def evaluate_dataset(cfg, model, dataset_name: Optional[str] = None,
                     max_samples: Optional[int] = None,
                     image_logger=None, log_step: int = 0,
                     visualize_dir: Optional[str] = None
                     ) -> Dict[str, Dict[str, float]]:
    """Run the evaluator stack over a test split with ``model`` on the
    device its parameters are on.

    Returns {group: {metric: value}}: 'panoptic_seg' (PQ, SQ, RQ of All,
    Things, Stuff), 'sem_seg' with TEST.EVAL_SEMANTIC, 'depth' with depth,
    'instances' with TEST.EVAL_INSTANCE, and 'eval_speed' (images/s, the
    number of images and, on a card, the peak memory in GiB). The first
    two predictions go to ``image_logger.log_image`` and, with
    ``visualize_dir``, to PNG files there.
    """
    device = next(model.parameters()).device
    dataset_name = dataset_name or cfg.DATASETS.TEST[0]
    dataset = DatasetCatalog.get(dataset_name)
    if max_samples:
        dataset = dataset[:max_samples]
    n_proc = process_count()
    if n_proc > 1:
        dataset = dataset[process_index()::n_proc]
    meta = MetadataCatalog.get(dataset_name)
    mapper = locate(cfg.INPUT.TEST_DATASET_MAPPER)(
        cfg, dataset_name=dataset_name)
    statics = statics_from_meta(cfg, meta)
    eval_step = (_make_tta_step(cfg) if cfg.TEST.MSC_FLIP_EVAL
                 else make_eval_step(cfg))

    evaluators = {}
    if cfg.WITH_PANOPTIC:
        evaluators["panoptic"] = PanopticEvaluator(meta)
        if cfg.TEST.EVAL_SEMANTIC:
            evaluators["semantic"] = SemSegEvaluator(meta)
    if cfg.WITH_DEPTH:
        evaluators["depth"] = DepthEvaluator(
            min_depth=cfg.TEST.MIN_DEPTH, max_depth=cfg.TEST.MAX_DEPTH,
            use_gt_scale=not cfg.MODEL.POST_PROCESSING.USE_DGC_SCALING,
            use_eigen_crop="kitti" in dataset_name,
        )

    visualizer = None
    if image_logger is not None or visualize_dir or cfg.VISUALIZE_EVALUATION:
        visualizer = Visualizer(meta)
        if visualize_dir:
            os.makedirs(visualize_dir, exist_ok=True)
    logged_images = 0

    instances_out = [] if cfg.TEST.EVAL_INSTANCE else None
    if cfg.TEST.EVAL_INSTANCE:
        evaluators["instance_ap"] = InstanceAPEvaluator(meta)
    thing_train_ids = set(meta.thing_dataset_id_to_contiguous_id.values())

    div = cfg.MODEL.SIZE_DIVISIBILITY
    # one pad bucket for the split: test-mapper outputs have shortest edge
    # MIN_SIZE_TEST and longest <= MAX_SIZE_TEST
    bucket_h = -(-cfg.INPUT.MIN_SIZE_TEST // div) * div
    bucket_w = -(-cfg.INPUT.MAX_SIZE_TEST // div) * div
    batch_size = max(1, int(
        cfg.TEST.TTA_IMS_PER_BATCH if cfg.TEST.MSC_FLIP_EVAL
        else cfg.TEST.IMS_PER_BATCH))
    need_probs = instances_out is not None

    @torch.no_grad()
    def run_device_batch(imgs, cams, cam_hs, h2, w2, height, width):
        """One batched forward and the post-processing on the device; the
        outputs compacted, then one copy to the host per batch."""
        out = eval_step(model, torch.from_numpy(imgs).to(device))

        def to_full(x):
            return interpolate_bilinear(x[:, :h2, :w2], (height, width))

        res = {}
        pan = None
        if cfg.WITH_PANOPTIC:
            sem_logits = to_full(out["sem_seg"].float())
            center = to_full(out["center"].float())
            offset = to_full(out["offset"].float())
            sem = torch.argmax(sem_logits.permute(0, 3, 1, 2), dim=1).int()
            pan = panoptic_fusion(sem, center[..., 0], offset,
                                  **fusion_kwargs(statics))
            res["sem"] = sem.to(torch.uint8)
            res["pan"] = pan.to(torch.int16)
            res["center"] = center[..., 0].half()
            if need_probs:
                res["probs"] = (
                    sem_logits  # TTA: already averaged probabilities
                    if cfg.TEST.MSC_FLIP_EVAL
                    else torch.softmax(sem_logits, dim=-1)
                ).half()
        if cfg.WITH_DEPTH:
            depth = to_full(out["depth"].float())
            dpp, _ = depth_postprocess(
                depth,
                torch.from_numpy(cams).to(device) if cams is not None
                else None,
                torch.from_numpy(cam_hs).to(device),
                pan,
                use_dgc_scaling=cfg.MODEL.POST_PROCESSING.USE_DGC_SCALING,
                road_class_id=statics.road_class_id,
                filter_class_ids=statics.depth_filter_ids,
            )
            # the far-plane sentinel (1 / 1e-6 = 1e6 m) clamped into f16
            # range: past the evaluator's max depth it is masked anyway
            res["depth"] = torch.clamp(dpp, max=6.0e4).half()
        return to_host(res)

    def process_one(sample_idx, d, sample, res, i):
        """Host-side GT loading + evaluator accumulation for one sample."""
        nonlocal logged_images
        result = {}
        gt_meta = sample.get("meta", {})
        if cfg.WITH_PANOPTIC:
            pan_np = res["pan"][i]
            result["panoptic"] = pan_np
            gt_pan = None
            if gt_meta.get("pan_seg_file_name"):
                gt_pan = rgb2id(read_image(gt_meta["pan_seg_file_name"]))
                evaluators["panoptic"].process(
                    pan_np, gt_pan, gt_meta.get("segments_info"))
                if "semantic" in evaluators:
                    # semantic GT from the panoptic map + segments
                    gt_sem = np.full_like(gt_pan, 255, dtype=np.int32)
                    for s in gt_meta.get("segments_info", []):
                        gt_sem[gt_pan == s["id"]] = s["category_id"]
                    # instance masks for the iIoU weighting (non-crowd
                    # things, cityscapesscripts semantics)
                    gt_inst_masks = [
                        dict(category_id=s["category_id"],
                             mask=gt_pan == s["id"])
                        for s in gt_meta.get("segments_info", [])
                        if s["category_id"] in thing_train_ids
                        and not s.get("iscrowd", 0)
                    ]
                    evaluators["semantic"].process(
                        res["sem"][i], gt_sem, gt_instances=gt_inst_masks)

            if instances_out is not None:
                pred_inst = extract_instances(
                    res["probs"][i], res["center"][i], pan_np,
                    thing_ids=sorted(thing_train_ids),
                    label_divisor=statics.label_divisor,
                )
                instances_out.append(dict(
                    image_id=sample.get("image_id", str(sample_idx)),
                    instances=pred_inst,
                ))
                if gt_pan is not None:
                    gt_inst = [
                        dict(category_id=s["category_id"],
                             mask=gt_pan == s["id"],
                             iscrowd=s.get("iscrowd", 0))
                        for s in gt_meta.get("segments_info", [])
                        if s["category_id"] in thing_train_ids
                    ]
                    # void = pixels not covered by any GT segment
                    evaluators["instance_ap"].process(
                        pred_inst, gt_inst, void_mask=gt_pan == 0)

        if cfg.WITH_DEPTH:
            dpp_i = res["depth"][i]
            if gt_meta.get("depth_file_name") or gt_meta.get(
                    "disparity_file_name"):
                evaluators["depth"].process(
                    dpp_i, {**gt_meta, "calibration_info":
                            gt_meta.get("calibration_info")})
            result["depth_vis"] = dpp_i

        # eval-time images: the first two predictions
        if visualizer is not None and logged_images < 2:
            image_u8 = read_image(d["file_name"])
            images = {}
            if "panoptic" in result:
                images["panoptic"] = visualizer.panoptic_rgb(
                    result["panoptic"], image_u8)
            if "depth_vis" in result:
                images["depth"] = visualizer.depth_rgb(result["depth_vis"])
            for name, rgb in images.items():
                if image_logger is not None:
                    image_logger.log_image(
                        log_step, f"eval/{name}_{logged_images}", rgb)
                if visualize_dir:
                    visualizer._save(os.path.join(
                        visualize_dir, f"eval_{sample_idx:04d}_{name}.png"),
                        rgb)
            logged_images += 1

    def prepare(args):
        sample_idx, d = args
        sample = mapper(d)
        img = sample["image"]
        h2, w2 = img.shape[:2]
        ph = bucket_h if h2 <= bucket_h else -(-h2 // div) * div
        pw = bucket_w if w2 <= bucket_w else -(-w2 // div) * div
        padded = np.zeros((ph, pw, 3), np.float32)
        padded[:h2, :w2] = img
        return sample_idx, d, sample, padded

    def flush(key, items, final=False):
        _, _, h2, w2, height, width = key
        imgs = [it[3] for it in items]
        cams = [np.asarray(it[2]["camera_matrix"], np.float32)
                if "camera_matrix" in it[2] else None for it in items]
        cam_hs = [float(it[2].get("camera_height", 1.0)) for it in items]
        # repeat-pad a partial bucket; process_one below sees only the
        # real ``items``, so pad copies never reach an evaluator
        pad_to = eval_pad_to(len(imgs), batch_size, final)
        while len(imgs) < pad_to:
            imgs.append(imgs[-1])
            cams.append(cams[-1])
            cam_hs.append(cam_hs[-1])
        have_cams = all(c is not None for c in cams)
        res = run_device_batch(
            np.stack(imgs), np.stack(cams) if have_cams else None,
            np.asarray(cam_hs, np.float32), h2, w2, height, width)
        for i, it in enumerate(items):
            process_one(it[0], it[1], it[2], res, i)

    def bucket_key(item):
        sample, padded = item[2], item[3]
        return (padded.shape[0], padded.shape[1],
                sample["image"].shape[0], sample["image"].shape[1],
                sample["height"], sample["width"])

    t_eval = time.time()
    with ThreadPoolExecutor(max(1, int(cfg.DATALOADER.NUM_WORKERS))) as pool:
        n_images = run_bucketed_eval(pool.map(prepare, enumerate(dataset)),
                                     bucket_key, batch_size, flush)
    eval_seconds = time.time() - t_eval

    results: Dict[str, Dict[str, float]] = {}
    for ev in evaluators.values():
        results.update(ev.evaluate())
    if instances_out is not None:
        results.setdefault("instances", {}).update({
            "num_images": len(instances_out),
            "num_instances": float(sum(
                len(e["instances"]) for e in instances_out)),
        })
    if n_images and eval_seconds > 0:
        results["eval_speed"] = {
            "images_per_s": n_images / eval_seconds,
            "num_images": float(n_images),
        }
        peak = peak_hbm_gb(device)
        if peak is not None:
            results["eval_speed"]["peak_hbm_gb"] = peak
    return results
