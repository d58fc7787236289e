"""Metrics/observability: JSONL always, TensorBoard when available.

A copy of ``mt3d_resenc_unet_tpu/train/metrics.py``.

The reference logs per-task epoch-mean train losses to TensorBoard and
prints running losses to tqdm (reference: train.py:170, 234-246). Here every
scalar goes to an append-only JSONL file (machine-readable, no deps) and,
when the tensorboard package is importable, mirrored to TB scalars.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, Optional


class MetricsWriter:
    def __init__(self, log_dir, model_name: str = "model",
                 use_tensorboard: bool = True):
        self.log_dir = Path(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self.jsonl_path = self.log_dir / f"{model_name}_metrics.jsonl"
        self._file = open(self.jsonl_path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=str(self.log_dir))
            except Exception:
                self._tb = None

    def write(self, step: int, scalars: Dict[str, float],
              prefix: str = "") -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            key = f"{prefix}{k}" if prefix else k
            rec[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), int(step))
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()
        if self._tb is not None:
            self._tb.close()
