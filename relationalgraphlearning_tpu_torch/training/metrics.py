"""Structured metrics (port of ``relationalgraphlearning_tpu/training/metrics.py``).

Every record is appended to ``metrics.jsonl`` in the run's directory, and
to TensorBoard when ``torch.utils.tensorboard`` imports (the reference's
gate: TensorBoard is optional).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Mapping


class MetricsWriter:
    def __init__(self, output_dir: str, use_tensorboard: bool = True):
        os.makedirs(output_dir, exist_ok=True)
        self.jsonl_path = os.path.join(output_dir, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=output_dir)
            except ImportError:
                logging.getLogger(__name__).info(
                    "tensorboard unavailable; jsonl metrics only")

    def write(self, step: int, values: Mapping[str, float], prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            name = f"{prefix}/{k}" if prefix else k
            rec[name] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(name, float(v), int(step))
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
