"""Reading the traced run: a ``torch.profiler`` Chrome trace.

Device activity is every complete event of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` (a ``gpu_user_annotation`` is a label,
not work). Busy time is the union of their intervals, so work on two
streams at once counts once. What the host was doing in an idle gap is
the innermost host event (a ``cpu_op``, a ``user_annotation`` such as
the harness's ``searchbench.*`` labels, or a CUDA runtime call) that
covers the gap's middle. The arithmetic of
``benchmarks/port_request_profile.py``'s device table and idle share,
copied onto the trace's own intervals.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NO_HOST_OP = "no torch op on any thread (service queue, flush, demux)"


def load(path) -> List[dict]:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def device_intervals(events: Sequence[dict]) -> List[Tuple[float, float,
                                                           str]]:
    """(start us, end us, name) of every device event, by start."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "?")) for e in events
                  if e.get("cat") in DEVICE_CATS)


def busy_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b, _ in intervals:
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def op_seconds(intervals) -> Dict[str, float]:
    """Device seconds by operation name, largest first."""
    by = defaultdict(float)
    for a, b, name in intervals:
        by[name] += (b - a) / 1e6
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def kernel_seconds(intervals, patterns: Sequence[str]) -> float:
    """Device seconds of the kernels whose name holds every pattern."""
    return sum(b - a for a, b, name in intervals
               if all(p in name for p in patterns)) / 1e6


def gaps(intervals) -> List[Tuple[float, float]]:
    """The idle stretches between device work, in order."""
    out, end = [], None
    for a, b, _ in intervals:
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def idle_by_host(events: Sequence[dict], intervals) -> Dict[str, float]:
    """Idle seconds between device work, by the innermost host event that
    covers each gap's middle; largest first."""
    host = sorted((float(e["ts"]), float(e["dur"]), e.get("name", "?"))
                  for e in events if e.get("cat") in HOST_CATS)
    by = defaultdict(float)
    j, active = 0, []
    for a, b in gaps(intervals):              # in order, so mids rise
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[0] + h[1] >= mid]
        inner = min(active, key=lambda h: h[1], default=None)
        by[NO_HOST_OP if inner is None else inner[2]] += (b - a) / 1e6
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[name, s] for name, s in list(d.items())[:n]]
