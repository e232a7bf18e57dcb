"""Cooperative preemption handling for long training runs.

The port's copy of `PreemptionGuard` (wav2vec_contr_loss_tpu/utils/
preemption.py). Schedulers deliver SIGTERM with a short
grace window before killing a job; the guard turns the signal into a flag
that `Stage1Trainer.fit` polls at step boundaries. On a request, fit
saves the full train state (parameters, optimizer moments, step, the
trainer's generator, the batch cursor) and returns, and a resume replays
the epoch past the cursor to the same bits an uninterrupted run gives.

In a gang of several processes the signal may reach one rank only, and
the mid-epoch save is a collective: every `sync_every` calls the ranks
agree on the flag with one small all-reduce (MAX), so all of them stop
at the same step.
"""
from __future__ import annotations

import signal
import threading
from typing import Optional, Sequence

import torch

from . import distributed

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Install signal handlers that set a flag instead of killing the
    process; trainers poll `requested(step)` at step boundaries.

    Use as a context manager (handlers are restored on exit) or call
    `install()` / `uninstall()`. `mark()` sets the flag programmatically
    (tests, or a wrapper that learns of a preemption another way).
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,),
                 sync_every: int = 16):
        self.signals = tuple(signals)
        self.sync_every = max(1, int(sync_every))
        self._flag = threading.Event()
        self._prev: dict = {}
        self._agreed = False   # the last value agreed across processes

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
        """True once a stop has been requested (and, in a gang, agreed).

        One process: the local flag, every call. A gang: the OR of every
        rank's flag, agreed every `sync_every` calls when `step` (the
        caller's batch cursor) is given, every call when not; every rank
        must call it at the same steps."""
        if distributed.world_size() == 1:
            return self._flag.is_set()
        if self._agreed:
            return True
        if step is not None and step % self.sync_every != 0:
            return False
        import torch.distributed as dist

        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        flag = torch.tensor([int(self._flag.is_set())], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        self._agreed = bool(flag.item())
        return self._agreed
