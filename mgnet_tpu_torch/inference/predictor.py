"""The serving API: one image, or a batch of resized images, in; numpy out.

Port of ``mgnet_tpu/inference/predictor.py``. ``Predictor`` loads the
weights, resizes the image as the test mapper does (Pillow-exact
BILINEAR), builds the camera matrix from a calibration dict and moves it
with the resize, runs the fused frame (``inference/fused.py``) or, with
``TEST.MSC_FLIP_EVAL``, the multi-scale + flip TTA followed by the
argmax and the panoptic fusion, and returns numpy arrays. On a CUDA
device the fusion's clustering is the ``center_argmin`` kernel.

Kept from the JAX class on purpose: the TTA frame ignores the camera (no
DGC, no depth filter, no point cloud), and a camera matrix given without
a height gets a height of 1.0.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from mgnet_tpu_torch.data.catalog import MetadataCatalog
from mgnet_tpu_torch.data.categories import (
    CITYSCAPES_CATEGORIES,
    CITYSCAPES_SCENE_SEG_CATEGORIES,
    build_meta,
)
from mgnet_tpu_torch.data.mapper import (
    TestDatasetMapper,
    _camera_matrix_from_calib,
)
from mgnet_tpu_torch.inference.fused import (
    build_fused_inference,
    fusion_kwargs,
    statics_from_meta,
)
from mgnet_tpu_torch.inference.tta import multi_scale_flip_inference
from mgnet_tpu_torch.models import build_model, init_random_
from mgnet_tpu_torch.postprocessing.panoptic import panoptic_fusion
from mgnet_tpu_torch.train.step import normalize_images
from mgnet_tpu_torch.utils.weights import load_eval_weights

__all__ = ["Predictor"]


def _tta_frame(model, statics, pixel_mean, pixel_std, with_panoptic,
               with_depth, device):
    """fn(image [B,H,W,3] raw RGB, camera_matrix=None, camera_height=None)
    -> the multi-scale + flip averages, fused: 'panoptic', 'sem_seg',
    'center', 'offset' with panoptic, 'depth' (the network's, unscaled)
    with depth. The camera arguments are accepted and not used."""

    @torch.inference_mode()
    def frame(image, camera_matrix=None, camera_height=None):
        image = torch.as_tensor(image, device=device)
        out = multi_scale_flip_inference(
            model, normalize_images(image, pixel_mean, pixel_std),
            with_panoptic=with_panoptic, with_depth=with_depth)
        result: Dict[str, torch.Tensor] = {}
        if with_panoptic:
            sem = torch.argmax(out["sem_seg"], dim=-1).int()
            center = out["center"][..., 0]
            result["panoptic"] = panoptic_fusion(sem, center, out["offset"],
                                                 **fusion_kwargs(statics))
            result.update(sem_seg=sem, center=center, offset=out["offset"])
        if with_depth:
            result["depth"] = out["depth"][..., 0]
        return result

    return frame


class Predictor:
    """Serve ``cfg``'s model on ``device``.

    The model is ``model`` when given (moved to ``device``, eval mode);
    otherwise ``build_model(cfg)`` with weights drawn from ``cfg.SEED``,
    then ``checkpoint_path or cfg.MODEL.WEIGHTS`` loaded if set: a
    ``model_final`` directory or an npz grafted where name and shape
    match (the ``.npz`` suffix may be left out; zero matches raise
    ``ValueError``). The dataset's metadata gives the post-processing
    statics; a dataset that is not registered gets the 20-class scene-seg
    categories for a 20-class model and the 19 Cityscapes ones otherwise.
    """

    def __init__(self, cfg, model=None, checkpoint_path: Optional[str] = None,
                 calibration_info: Optional[Dict] = None,
                 dataset_name: Optional[str] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if model is None:
            model = build_model(cfg, device="cpu")
            init_random_(model, torch.Generator().manual_seed(cfg.SEED))
            path = checkpoint_path or cfg.MODEL.WEIGHTS
            if path and not os.path.isfile(path) and os.path.isfile(
                    path + ".npz"):
                path = path + ".npz"
            if path:
                load_eval_weights(model, path)
        self.model = model.to(self.device).eval()

        meta = MetadataCatalog.get(dataset_name or cfg.DATASETS.TEST[0])
        if meta.get("categories") is None:
            meta.set(**build_meta(
                CITYSCAPES_SCENE_SEG_CATEGORIES
                if cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES == 20
                else CITYSCAPES_CATEGORIES))
        self.metadata = meta
        self.statics = statics_from_meta(cfg, meta)
        self.use_tta = bool(cfg.TEST.MSC_FLIP_EVAL)
        self.fused = self._frame(cfg.WITH_DEPTH, True)
        self._fused_filtered: Dict = {}
        self.mapper = TestDatasetMapper(cfg)
        self.calibration_info = calibration_info

    def _frame(self, with_depth: bool, return_point_cloud: bool):
        cfg = self.cfg
        args = (self.model, self.statics, tuple(cfg.MODEL.PIXEL_MEAN),
                tuple(cfg.MODEL.PIXEL_STD))
        if self.use_tta:
            return _tta_frame(*args, cfg.WITH_PANOPTIC, with_depth,
                              self.device)
        return build_fused_inference(
            *args, with_panoptic=cfg.WITH_PANOPTIC, with_depth=with_depth,
            return_point_cloud=return_point_cloud, device=self.device)

    def available_outputs(self) -> set:
        """The result keys this configuration produces."""
        available = set()
        if self.cfg.WITH_PANOPTIC:
            available |= {"sem_seg", "center", "offset", "panoptic"}
        if self.cfg.WITH_DEPTH:
            available.add("depth")
            if (self.cfg.MODEL.POST_PROCESSING.USE_DGC_SCALING
                    and not self.use_tta):
                available.add("points")
        return available

    def prepare(self, image: np.ndarray,
                camera_matrix: Optional[np.ndarray] = None,
                camera_height: Optional[float] = None):
        """What ``__call__`` gives the frame for ``image`` [H, W, 3] uint8
        RGB: the resized image [H', W', 3] float32 and, when there is a
        camera (``camera_matrix``, else the calibration's), its matrix
        [3, 3] float32 moved with the resize and its height (the
        calibration's, ``camera_height``, or 1.0); else None, None."""
        h, w = image.shape[:2]
        t = self.mapper._resize(h, w)
        resized = t.apply_image(image).astype(np.float32)
        if camera_matrix is None and self.calibration_info is not None:
            camera_matrix = _camera_matrix_from_calib(self.calibration_info)
            camera_height = self.calibration_info["extrinsic"]["z"]
        if camera_matrix is None:
            return resized, None, None
        oc = t.apply_coords(np.array(
            [[camera_matrix[0, 2], camera_matrix[1, 2]]]))
        fl = t.apply_focal(np.array(
            [[camera_matrix[0, 0], camera_matrix[1, 1]]]))
        K = np.array([[fl[0, 0], 0, oc[0, 0]],
                      [0, fl[0, 1], oc[0, 1]],
                      [0, 0, 1]], np.float32)
        return resized, K, 1.0 if camera_height is None else camera_height

    def __call__(self, image: np.ndarray,
                 camera_matrix: Optional[np.ndarray] = None,
                 camera_height: Optional[float] = None
                 ) -> Dict[str, np.ndarray]:
        """image: [H, W, 3] uint8 RGB. Returns the frame's outputs for it,
        each a numpy array at the resized size."""
        resized, K, height = self.prepare(image, camera_matrix,
                                          camera_height)
        kwargs = {}
        if K is not None:
            kwargs = dict(camera_matrix=K[None],
                          camera_height=np.array([height], np.float32))
        out = self.fused(resized[None], **kwargs)
        return {k: v[0].cpu().numpy() for k, v in out.items()}

    def predict_batch(self, images_resized: np.ndarray,
                      camera_matrix: Optional[np.ndarray] = None,
                      camera_height: Optional[np.ndarray] = None,
                      outputs: Optional[tuple] = None,
                      materialize: bool = True) -> Dict:
        """The frame on a batch of images already resized to one shape.

        Args:
            images_resized: [B, H, W, 3] float32 raw RGB.
            camera_matrix: [B, 3, 3] at that size, or None; the heights
                [B] default to 1.0.
            outputs: the result keys to compute and return, or None for
                all. Checked before any work (an unknown key, or 'points'
                without a camera, raises ``ValueError``); a frame without
                the depth branch serves a request without depth keys, and
                one frame is kept for each key tuple. Only the requested
                tensors are copied to the host.
            materialize: False returns the tensors on the device, so that
                the caller can enqueue the next batch before it copies
                this one.
        Returns a dict of [B, ...] numpy arrays (or tensors).
        """
        kwargs = {}
        if camera_matrix is not None:
            kwargs["camera_matrix"] = np.asarray(camera_matrix, np.float32)
            kwargs["camera_height"] = (
                np.asarray(camera_height, np.float32)
                if camera_height is not None
                else np.ones((len(images_resized),), np.float32))
        fn = self.fused
        if outputs is not None:
            available = self.available_outputs()
            bad = [k for k in outputs if k not in available]
            if bad:
                raise ValueError(
                    f"predict_batch outputs {bad} not produced by this "
                    f"config (available: {sorted(available)})")
            if "points" in outputs and camera_matrix is None:
                raise ValueError(
                    "'points' requires camera_matrix (DGC unprojection)")
            key = tuple(outputs)
            if key not in self._fused_filtered:
                frame = self._frame(
                    with_depth=bool({"depth", "points"} & set(key)),
                    return_point_cloud="points" in key)

                def filtered(image, _frame=frame, _keys=key, **kw):
                    res = _frame(image, **kw)
                    return {k: res[k] for k in _keys}

                self._fused_filtered[key] = filtered
            fn = self._fused_filtered[key]
        out = fn(images_resized, **kwargs)
        if not materialize:
            return dict(out)
        return {k: v.cpu().numpy() for k, v in out.items()}
