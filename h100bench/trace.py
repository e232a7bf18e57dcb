"""Reading a `torch.profiler` trace: device busy time, kernels attributed
to the host ranges that launched them, and the breakdown.

A device operation is a kernel, a memcpy or a memset. A kernel belongs to
a host range (an autograd Function's forward, its backward node, a custom
op) when the runtime or driver call that launched it, matched by the
profiler's correlation id, lies inside that range on the same thread; so
the same work is read whatever kernel implements it.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = ("cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    device_ops: List[Tuple[str, float, float, Optional[int]]]  # name, ts, dur (us), corr
    launches: Dict[int, Tuple[int, float]]                     # corr -> (tid, ts)
    cpu_ops: List[Tuple[str, int, float, float]]               # name, tid, ts, dur


def load(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, launches, cpu = [], {}, []
    for e in events:
        cat = e.get("cat")
        if cat in _DEVICE:
            dev.append((e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)),
                        (e.get("args") or {}).get("correlation")))
        elif cat in _LAUNCH:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), float(e["ts"]))
        elif cat == "cpu_op":
            cpu.append((e.get("name", ""), e.get("tid"), float(e["ts"]),
                        float(e.get("dur", 0))))
    dev.sort(key=lambda x: x[1])
    return Trace(dev, launches, cpu)


def merged(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(t: Trace) -> float:
    return sum(e - s for s, e in merged((ts, ts + d) for _, ts, d, _ in
                                        t.device_ops)) * 1e-6


def _ranges_by_tid(t: Trace, names) -> Dict[int, List[Tuple[float, float]]]:
    out = defaultdict(list)
    for name, tid, ts, dur in t.cpu_ops:
        if name in names:
            out[tid].append((ts, ts + dur))
    return {k: sorted(v) for k, v in out.items()}


def _inside(ranges: List[Tuple[float, float]], ts: float) -> bool:
    i = bisect.bisect_right(ranges, (ts, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= ts <= ranges[i][1]


def attributed(t: Trace, names) -> Dict[str, Tuple[float, int, int]]:
    """{name: (device seconds of the operations launched inside host
    ranges of that name, ranges traced, ranges that launched some)}.
    Ranges of one name on one thread do not nest."""
    out = {}
    for name in names:
        by_tid = _ranges_by_tid(t, {name})
        total, hit = 0.0, set()
        for _, _, dur, corr in t.device_ops:
            if corr is None or corr not in t.launches:
                continue
            tid, ts = t.launches[corr]
            ranges = by_tid.get(tid)
            if ranges and _inside(ranges, ts):
                total += dur
                hit.add((tid, bisect.bisect_right(
                    ranges, (ts, float("inf"))) - 1))
        out[name] = (total * 1e-6, sum(len(v) for v in by_tid.values()),
                     len(hit))
    return out


def _outermost(t: Trace, tid: int, ts: float) -> str:
    best = None
    for name, otid, s, d in t.cpu_ops:
        if otid == tid and s <= ts <= s + d and (best is None or s < best[1]):
            best = (name, s)
    return best[0] if best else "no host op"


def breakdown(t: Trace, top: int = 10) -> Dict[str, List]:
    """The device operations that took most time (by name) and the
    longest idle gaps, each named by the outermost host op around the
    launch that ended it."""
    by_name: Dict[str, float] = defaultdict(float)
    for name, _, dur, _ in t.device_ops:
        by_name[name[:96]] += dur * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    end = None
    for name, ts, dur, corr in t.device_ops:
        if end is not None and ts > end:
            gaps.append((ts - end, corr))
        end = ts + dur if end is None else max(end, ts + dur)
    gaps.sort(key=lambda g: -g[0])
    out = []
    for gap, corr in gaps[:top]:
        where = "launch not traced"
        if corr in t.launches:
            where = _outermost(t, *t.launches[corr])[:96]
        out.append([where, gap * 1e-6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": out}
