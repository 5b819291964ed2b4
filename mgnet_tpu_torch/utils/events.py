"""Metric logging.

A copy of ``mgnet_tpu/utils/events.py``: scalars go to ``metrics.json`` in
the output directory, one JSON line per call,
``{"iteration": step, "time": seconds since the logger started, key:
value, ...}``, and to TensorBoard event files where the ``tensorboard``
package is installed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

__all__ = ["MetricLogger"]


class MetricLogger:
    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.json")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # no tensorboard package: metrics.json only
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir=output_dir)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]):
        record = {"iteration": int(step),
                  "time": round(time.time() - self._t0, 3)}
        record.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))

    def log_image(self, step: int, tag: str, image):
        if self._tb is not None:
            self._tb.add_image(tag, image, int(step), dataformats="HWC")

    def close(self):
        if self._tb is not None:
            self._tb.close()
