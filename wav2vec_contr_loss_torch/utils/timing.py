"""Named spans on the profiler's clock, and the port's profiler exporter.

`span(name)` names a stretch of the host's work as a `torch.profiler`
range. It lands in whatever profiler runs (a benchmark's, `fit
--profile_dir`'s, a user's own), on the clock of the kernels launched
inside it, and that profiler's exporter writes it out. With no profiler
running it is one shared no-op context and costs a flag test. Ranges on
one thread nest, so nesting is the parent link.

`start_profile` / `stop_profile` record the host's operators and, on the
card, its kernels into a Chrome trace (`fit(profile_dir=...)`).
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["span", "start_profile", "stop_profile"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A `record_function(name)` range while a profiler runs; otherwise
    the shared no-op context. The flag read is the Python-side one that
    every running `torch.profiler` sets, on every thread:
    `torch.autograd._profiler_enabled()` is thread-local and reads false
    on every thread of a profile that records all threads."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def start_profile(device: torch.device) -> torch.profiler.profile:
    """A started profiler over the host's operators and, on the card,
    its kernels."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_profile(prof: torch.profiler.profile, path: str,
                 last: torch.Tensor) -> str:
    """Stop `prof` once `last` (an output of the last profiled work) is
    on the host, and write its Chrome trace to `path`. -> a log line."""
    last.item()
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    return f"[PROFILE] trace written to {path}"
