"""Helpers of the per-layer metric readers (metrics/*.py)."""

from __future__ import annotations

import os

from . import trace as tr


def idle_share(ctx):
    """Percent of the stretch traced with the device's activity alone
    (which costs the host little; run.py prints what it costs) in which
    no device operation ran: one minus the union of the operations'
    intervals over the stretch's seconds."""
    trace = ctx.get("dev_trace")
    if trace is None or not trace.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_seconds(trace) / ctx["dev_window_s"])


def roofline_share(ctx, parts):
    """Percent: the least seconds of the calls over the device seconds of
    the operations they launched. `parts`: (host range name, least
    seconds of one call); the calls are the traced ranges of that name
    that launched device work. Nothing to read when none did."""
    trace = ctx.get("trace")
    if trace is None:
        return None
    found = tr.attributed(trace, [name for name, _ in parts])
    least = sum(found[name][2] * s for name, s in parts)
    seconds = sum(v[0] for v in found.values())
    print(f"[metric] (seconds, ranges, ranges with device work): {found}; "
          f"least {least:.6f} s; launch counters "
          f"{ctx['traced'].counters}", flush=True)
    if least <= 0 or seconds <= 0:
        return None
    return 100.0 * least / seconds



def same_as(path: str, name: str):
    """The `read` of metrics/<name>.py beside the reader at `path`: a
    quantity read alike in cells that report another end-to-end metric,
    under a name of its own there."""
    from . import spec

    return spec.metric_reader(os.path.dirname(os.path.dirname(
        os.path.abspath(path))), name)
