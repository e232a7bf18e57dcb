"""The program's named spans (`w2v.*` ranges) read out of a traced
stretch, with the device operations they launched and the idle gaps
those launches ended.

Everything comes from the profiler's own results for the stretch
(`torch.profiler` kineto events: nanosecond starts on one clock). A
device operation (kernel, copy, set) is launched by a CUDA API call,
matched by its correlation id, else by the host op it is linked to;
that gives the launching thread and moment. Attribution:

- an operation belongs to the innermost `w2v.*` span open on its
  launching thread at its launch;
- where that thread has none (autograd's device thread), to the
  innermost span open on the main thread (the one that runs `w2v.step`)
  at that moment: the backward's work lands in `w2v.backward`, or in
  `w2v.dropout` where a recompute's dropout span is open on its thread;
- an idle gap between device operations belongs to the span of the
  launch that ended it. The stretch runs from its first event to its
  last; the idle after the last operation is ended by no launch.

Spans are read exclusively: an operation counts for its innermost span
only, so a phase's device time leaves out the spans nested in it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

PREFIX = "w2v."
NONE = "(no span)"


@dataclass
class Stretch:
    # name, thread, start, end (us)
    spans: List[Tuple[str, int, float, float]]
    # start, duration (us), launch (thread, moment) or None
    device: List[Tuple[float, float, Optional[Tuple[int, float]]]]
    start: float    # the stretch's first event and last end, us
    end: float


def stretch(prof) -> Stretch:
    """The spans and device operations of a stopped `torch.profiler`
    profile, from its kineto events."""
    from torch.autograd import DeviceType

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    spans, ops, calls, dev = [], {}, {}, []
    lo, hi = float("inf"), float("-inf")
    for e in res.events():
        s = (e.start_ns() - t0) * 1e-3
        d = e.duration_ns() * 1e-3
        lo, hi = min(lo, s), max(hi, s + d)
        if e.device_type() == DeviceType.CPU:
            where = (e.start_thread_id(), s)
            if e.linked_correlation_id():     # a CUDA API call
                calls[e.correlation_id()] = where
                continue
            ops[e.correlation_id()] = where
            if e.name().startswith(PREFIX):
                spans.append((e.name(), e.start_thread_id(), s, s + d))
        elif not e.is_user_annotation():      # a range's device-side copy
            dev.append((s, d, e.correlation_id(), e.linked_correlation_id()))
    device = [(s, d, calls.get(corr, ops.get(link) if link else None))
              for s, d, corr, link in dev]
    return Stretch(spans, sorted(device, key=lambda x: x[0]), lo, hi)


def _timelines(spans) -> Dict[int, Tuple[List[float], List[Optional[str]]]]:
    """{thread: (moments, innermost span from each moment on)}; spans on
    one thread nest."""
    by_tid = defaultdict(list)
    for name, tid, s, e in spans:
        by_tid[tid].append((s, -e, name))
    out = {}
    for tid, items in by_tid.items():
        times, names, stack = [], [], []

        def pop_to(t):
            while stack and stack[-1][0] <= t:
                end, _ = stack.pop()
                times.append(end)
                names.append(stack[-1][1] if stack else None)

        for s, neg_e, name in sorted(items):
            pop_to(s)
            stack.append((-neg_e, name))
            times.append(s)
            names.append(name)
        pop_to(float("inf"))
        out[tid] = (times, names)
    return out


def _at(timeline, t: float) -> Optional[str]:
    if timeline is None:
        return None
    times, names = timeline
    i = bisect.bisect_right(times, t) - 1
    return names[i] if i >= 0 else None


def main_thread(st: Stretch) -> Optional[int]:
    tids = [tid for name, tid, _, _ in st.spans if name == PREFIX + "step"]
    return max(set(tids), key=tids.count) if tids else None


def attribute(st: Stretch) -> List[str]:
    """The span each device operation of `st` (in its order) belongs to;
    NONE where no span was open."""
    lines = _timelines(st.spans)
    main = lines.get(main_thread(st))
    out = []
    for _, _, launch in st.device:
        name = None
        if launch is not None:
            tid, t = launch
            name = _at(lines.get(tid), t) or _at(main, t)
        out.append(name or NONE)
    return out


def table(st: Stretch, steps: int) -> Dict[str, Dict[str, float]]:
    """{span: {'host_ms': on the main thread, 'other_ms': on other
    threads, 'device_ms', 'idle_ms'}}, each a step, with the row NONE
    for what fell to no span and '(stretch)' for the totals: 'host_ms'
    the stretch's length, 'device_ms' its busy time, 'idle_ms' its idle
    time, 'in_spans' the share of that idle time that fell to a span."""
    rows: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"host_ms": 0.0, "other_ms": 0.0, "device_ms": 0.0,
                 "idle_ms": 0.0})
    main = main_thread(st)
    for name, tid, s, e in st.spans:
        rows[name]["host_ms" if tid == main else "other_ms"] += e - s
    end, busy = st.start, 0.0
    for (s, d, _), name in zip(st.device, attribute(st)):
        rows[name]["device_ms"] += d
        if s > end:
            rows[name]["idle_ms"] += s - end
        busy += max(0.0, s + d - max(s, end))
        end = max(end, s + d)
    length = st.end - st.start
    idle = length - busy
    rows[NONE]["idle_ms"] += max(0.0, st.end - end)
    out = {k: {c: v * 1e-3 / steps for c, v in r.items()}
           for k, r in rows.items()}
    out["(stretch)"] = {
        "host_ms": length * 1e-3 / steps, "device_ms": busy * 1e-3 / steps,
        "idle_ms": idle * 1e-3 / steps,
        "in_spans": max(0.0, 100.0 * (1.0 - rows[NONE]["idle_ms"] / idle))
        if idle > 0 else 0.0}
    return out


def format_table(t: Dict[str, Dict[str, float]], steps: int,
                 n_ops: int) -> str:
    lines = [f"[spans] {steps} traced steps, {n_ops} device operations; "
             f"ms a step (host: main thread; other: other threads)",
             f"{'span':<16}{'host':>10}{'other':>10}{'device':>10}"
             f"{'idle':>10}"]
    for name in sorted(k for k in t if k.startswith(PREFIX)) + [NONE]:
        r = t.get(name)
        if r is not None:
            lines.append(f"{name:<16}{r['host_ms']:>10.3f}"
                         f"{r['other_ms']:>10.3f}{r['device_ms']:>10.3f}"
                         f"{r['idle_ms']:>10.3f}")
    s = t["(stretch)"]
    lines.append(f"{'(stretch)':<16}{s['host_ms']:>10.3f}{'':>10}"
                 f"{s['device_ms']:>10.3f}{s['idle_ms']:>10.3f}")
    lines.append(f"[spans] idle time in a {PREFIX}* span: "
                 f"{s['in_spans']:.2f} %")
    return "\n".join(lines)


def of(ctx) -> Optional[Dict[str, Dict[str, float]]]:
    """The span table of a traced run's stretch of host operators (read
    once and printed, then kept on it); None where that stretch ran no
    device operation."""
    traced, trace = ctx.get("traced"), ctx.get("trace")
    if traced is None or trace is None or not trace.device_ops:
        return None
    if getattr(traced, "span_table", None) is None:
        st = stretch(traced.prof)
        traced.span_table = table(st, traced.units)
        print(format_table(traced.span_table, traced.units, len(st.device)),
              flush=True)
    return traced.span_table


def read(ctx, span: str, column: str) -> Optional[float]:
    """One cell of the table; None where the program records no such
    span."""
    t = of(ctx)
    row = None if t is None else t.get(span)
    return None if row is None else row[column]
