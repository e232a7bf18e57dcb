"""Step timing and throughput, and a profiler context.

The port of wav2vec_contr_loss_tpu/utils/timing.py: `StepTimer` takes
the host clock around a step and, where JAX calls `block_until_ready`,
waits for the CUDA streams of the step's outputs (tensors, or dicts,
lists and tuples of them) before it reads the clock, so a step's time
is the device's and not the enqueue's; `Throughput` turns those times
into clips/s and clips/s a card. `profiler_trace(log_dir)` records a
`torch.profiler` trace (the CPU, and the card when there is one) into
<log_dir>/trace.json, where JAX writes a `jax.profiler` trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import torch

__all__ = ["StepTimer", "Throughput", "profiler_trace"]


def _wait(x) -> None:
    """Wait for the work that produces x on its device."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.current_stream(x.device).synchronize()
    elif isinstance(x, dict):
        for v in x.values():
            _wait(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _wait(v)


class StepTimer:
    """Wall-clock timer that waits for the device outputs of the step."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, *sync_on) -> float:
        for x in sync_on:
            _wait(x)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self, drop_first: int = 1) -> dict:
        ts = (self.times[drop_first:] if len(self.times) > drop_first
              else self.times)
        if not ts:
            return {"mean_s": 0.0, "min_s": 0.0, "steps": 0}
        return {"mean_s": sum(ts) / len(ts), "min_s": min(ts),
                "steps": len(ts)}


class Throughput:
    """clips/s (and clips/s a card) over train steps."""

    def __init__(self, clips_per_step: int, n_cards: int = 1):
        self.clips_per_step = clips_per_step
        self.n_cards = max(1, n_cards)
        self.timer = StepTimer()

    def start(self) -> None:
        self.timer.start()

    def stop(self, *sync_on) -> float:
        return self.timer.stop(*sync_on)

    def clips_per_sec(self, drop_first: int = 1) -> float:
        s = self.timer.summary(drop_first)
        return 0.0 if s["mean_s"] == 0 else self.clips_per_step / s["mean_s"]

    def clips_per_sec_per_card(self, drop_first: int = 1) -> float:
        return self.clips_per_sec(drop_first) / self.n_cards


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """A torch.profiler trace into <log_dir>/trace.json when a directory
    is given; nothing otherwise."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
