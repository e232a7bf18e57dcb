"""Cooperative preemption handling for long training runs.

The port's copy of `PreemptionGuard` (wav2vec_contr_loss_tpu/utils/
preemption.py), single process. Schedulers deliver SIGTERM with a short
grace window before killing a job; the guard turns the signal into a flag
that `Stage1Trainer.fit` polls at step boundaries. On a request, fit
saves the full train state (parameters, optimizer moments, step, the
trainer's generator, the batch cursor) and returns, and a resume replays
the epoch past the cursor to the same bits an uninterrupted run gives.
Agreeing on the flag across processes comes with the port's
multi-process training.
"""
from __future__ import annotations

import signal
import threading
from typing import Optional, Sequence

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Install signal handlers that set a flag instead of killing the
    process; trainers poll `requested(step)` at step boundaries.

    Use as a context manager (handlers are restored on exit) or call
    `install()` / `uninstall()`. `mark()` sets the flag programmatically
    (tests, or a wrapper that learns of a preemption another way).
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._flag = threading.Event()
        self._prev: dict = {}

    def install(self) -> "PreemptionGuard":
        # idempotent: a second install must not record the guard's own
        # handler as 'previous', or uninstall would leak it
        for sig in self.signals:
            if sig not in self._prev:
                self._prev[sig] = signal.signal(sig, self._on_signal)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _on_signal(self, signum, frame) -> None:
        self._flag.set()

    def mark(self) -> None:
        """Request a graceful stop programmatically."""
        self._flag.set()

    def requested(self, step: Optional[int] = None) -> bool:
        """True once a stop has been requested. `step` is the caller's
        batch cursor, kept for the multi-process form's polling cadence."""
        return self._flag.is_set()
