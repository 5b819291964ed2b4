"""Metric logging.

A copy of ``mgnet_tpu/utils/events.py``: scalars go to ``metrics.json`` in
the output directory, one JSON line per call,
``{"iteration": step, "time": seconds since the logger started, key:
value, ...}``, and to TensorBoard event files where the ``tensorboard``
package is installed. Under several processes only process 0 logs: on
the others every call is a no-op.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

from mgnet_tpu_torch.parallel.multihost import is_main_process

__all__ = ["MetricLogger"]


class MetricLogger:
    def __init__(self, output_dir: str):
        self.path = os.path.join(output_dir, "metrics.json")
        self.enabled = is_main_process()
        self._tb = None
        self._t0 = time.time()
        if not self.enabled:
            return
        os.makedirs(output_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # no tensorboard package: metrics.json only
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir=output_dir)

    def log(self, step: int, metrics: Dict[str, float]):
        if not self.enabled:
            return
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
