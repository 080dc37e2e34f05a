"""Training observability: JSONL metrics log + optional TensorBoard.

Counterpart of generativemodels_tpu/utils/logging.py: a JSONL file always,
and TensorBoard summaries through `torch.utils.tensorboard` where it
imports (the JAX logger uses flax's writer the same way).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricsLogger:
    """Append-only JSONL metrics writer with optional TensorBoard mirror."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True) -> None:
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._file = open(self.path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # no tensorboard package: JSONL only
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir)

    def log(self, step: int, metrics: dict[str, Any]) -> None:
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = str(v)
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._tb is not None:
            for k, v in record.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()
