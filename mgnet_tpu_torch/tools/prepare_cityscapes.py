"""Convert Cityscapes instanceIds PNGs to COCO-panoptic format.

    python -m mgnet_tpu_torch.tools.prepare_cityscapes
        --input-dir datasets/cityscapes/gtFine/train
        --output-dir datasets/cityscapes/gtFine/cityscapes_panoptic_train
        --json datasets/cityscapes/gtFine/cityscapes_panoptic_train.json
        [--workers 8]

The counterpart of ``datasets/prepare_cityscapes.py``, with its flags,
over ``data.prepare.convert2panoptic``: one ``<stem>_panoptic.png`` per
``*_instanceIds.png`` under ``--input-dir`` and the COCO-panoptic JSON.
PNGs are read and written by ``data.image_io``, so neither Pillow nor the
JAX package is needed. ``--workers`` processes convert the files (0: this
process). It runs on the host.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from mgnet_tpu_torch.data.prepare import convert2panoptic

__all__ = ["main", "parse_args"]


def parse_args(argv: Optional[List[str]] = None,
               doc: str = __doc__) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--input-dir", required=True,
                   help="directory containing *_instanceIds.png")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--json", required=True)
    p.add_argument("--workers", type=int, default=8)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    a = parse_args(argv)
    convert2panoptic(a.input_dir, a.output_dir, a.json, a.workers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
