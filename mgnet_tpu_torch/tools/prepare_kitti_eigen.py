"""Convert KITTI pseudo-label instanceIds PNGs to COCO-panoptic format.

    python -m mgnet_tpu_torch.tools.prepare_kitti_eigen
        --input-dir datasets/kitti_eigen_pseudo
        --output-dir datasets/kitti_eigen/panoptic
        --json datasets/kitti_eigen/panoptic.json [--workers 8]

The counterpart of ``datasets/prepare_kitti_eigen.py``, with its flags,
over ``data.prepare.convert2panoptic(kitti=True)``: each panoptic PNG keeps
the drive tree (``<date>/<drive>/label_02/data/<frame>.png``, relative to
``--input-dir``) so that the KITTI registry maps it back to its image.
No Pillow, no JAX; ``--workers`` processes (0: this process), on the host.
"""

from __future__ import annotations

from typing import List, Optional

from mgnet_tpu_torch.data.prepare import convert2panoptic
from mgnet_tpu_torch.tools.prepare_cityscapes import parse_args

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> int:
    a = parse_args(argv, __doc__)
    convert2panoptic(a.input_dir, a.output_dir, a.json, a.workers,
                     kitti=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
