"""Inspect augmented training samples as PNGs.

    python -m mgnet_tpu_torch.tools.visualize_data --config-file FILE
        --output DIR [--data-root ./datasets] [--num-samples 8]
        [KEY VALUE ...]

The counterpart of ``tools/visualize_data.py``: the config's training
mapper (``INPUT.TRAIN_DATASET_MAPPER``, as the Trainer builds it) runs on
the first ``--num-samples`` entries of ``DATASETS.TRAIN[0]`` with a
generator seeded 0, and for each sample ``sampleNNN_image.png`` (the
augmented image), ``sampleNNN_sem.png`` (the semantic target in the
categories' colours) and ``sampleNNN_instances.png`` (the center heatmap
and offset directions through ``inference.visualizer``) are written with
``data.image_io.write_png``. The mapper and the colouring are numpy on
the host.
"""

from __future__ import annotations

import argparse
import os
from pydoc import locate
from typing import List, Optional

import numpy as np

from mgnet_tpu_torch.config import load_config
from mgnet_tpu_torch.data import DatasetCatalog, MetadataCatalog
from mgnet_tpu_torch.data.image_io import write_png
from mgnet_tpu_torch.inference.visualizer import Visualizer
from mgnet_tpu_torch.tools.train_net import register_datasets

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--data-root", default="./datasets")
    p.add_argument("--output", required=True)
    p.add_argument("--num-samples", type=int, default=8)
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    cfg = load_config(args.config_file, args.opts)
    register_datasets(args)
    name = cfg.DATASETS.TRAIN[0]
    dataset = DatasetCatalog.get(name)
    meta = MetadataCatalog.get(name)
    mapper = locate(cfg.INPUT.TRAIN_DATASET_MAPPER)(cfg, dataset_name=name)
    vis = Visualizer(meta)
    os.makedirs(args.output, exist_ok=True)

    rng = np.random.default_rng(0)
    for i, d in enumerate(dataset[: args.num_samples]):
        s = mapper(d, rng=rng)
        stem = os.path.join(args.output, f"sample{i:03d}")
        write_png(f"{stem}_image.png", s["image"].astype(np.uint8))
        sem = s["sem_seg"]
        rgb = np.zeros(sem.shape + (3,), np.uint8)
        for c in meta.categories:
            rgb[sem == c["trainId"]] = c["color"]
        write_png(f"{stem}_sem.png", rgb)
        write_png(f"{stem}_instances.png",
                  vis.instance_heatmap_rgb(s["center"][..., 0], s["offset"]))
        print(f"sample{i:03d} written")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
