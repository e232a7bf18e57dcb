"""Structured training metrics: the printed one-liners, a JSONL stream and
TensorBoard scalars.

The port of wav2vec_contr_loss_tpu/utils/logging.py (`MetricsLogger`).
`log(step, metrics, message)` prints the message, appends
{"step", "time", **metrics} to <log_dir>/metrics.jsonl and, with
`tensorboard`, writes each finite number as a scalar through
`torch.utils.tensorboard` (imported in the constructor; where it is
absent the logger warns, as the JAX class does, and goes on without
it). `Stage1Trainer.fit` takes one as its `metrics_logger`. In a gang
of several processes only rank 0 prints and writes: every rank logs the
same global-batch numbers.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from . import distributed

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 tensorboard: bool = False, print_fn=print):
        self.print_fn = print_fn
        self.log_dir = log_dir
        self.primary = distributed.is_primary()
        self._jsonl = None
        self._tb = None
        if log_dir and self.primary:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(log_dir)
                except ImportError as e:   # tensorboard is optional
                    self.print_fn(f"[WARN] TensorBoard unavailable: {e}")

    def log(self, step: int, metrics: Dict,
            message: Optional[str] = None) -> None:
        if not self.primary:
            return
        if message:
            self.print_fn(message)
        if self._jsonl is not None:
            rec = {"step": step, "time": time.time(), **metrics}
            self._jsonl.write(json.dumps(rec, default=float) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)) and v == v:   # skip NaN
                    self._tb.add_scalar(k, v, global_step=step)
            self._tb.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
