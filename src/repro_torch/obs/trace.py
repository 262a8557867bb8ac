"""Per-query trace spans (DESIGN.md §8.2).

A copy of ``repro.obs.trace``: the two packages keep the same
instruments, names and rules.

A ``QueryTrace`` is a tree of ``Span`` nodes mirroring the request
path: the root covers the whole query; children cover plan build,
per-segment loads (with slab source and decode/upload timings), scoring
calls, the final fold, and — on the cluster tier — one subtree per
shard with straggler attribution. Spans carry free-form ``attrs`` so a
stage can record its verdict (``source="cache"``, ``skipped=7``)
alongside its interval.

Two properties keep this safe on the hot path:

- **One lock per trace, not per span.** Spans are appended from the
  prefetch worker and shard-pool threads concurrently with the
  consumer; all children share the root's lock, taken only on
  ``child()``/``set()`` — never while the stage itself runs.
- **``NULL_SPAN`` when sampling is off.** ``Tracer.start`` returns
  ``None`` unless this query is sampled; callers thread ``NULL_SPAN``
  instead, whose ``child()`` returns itself. The instrumented path then
  costs one attribute call per stage and allocates nothing, which is
  how tracing-off stays inert (differential-tested bit-identical).

``Tracer`` owns the sampling decision (``sample_every=N``; 0 = off,
the default) and ring-buffers the finished traces (``recent``,
``last_trace``) so any session/service/router can hand back its most
recent ``QueryTrace`` without plumbing.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional


class Span:
    """One timed interval in a trace tree. Create via ``QueryTrace`` or
    ``parent.child(...)``; close with ``end()`` (idempotent) or use as a
    context manager."""
    __slots__ = ("name", "t0", "t1", "attrs", "children", "_lock")

    def __init__(self, name: str, _lock: threading.Lock, **attrs):
        self.name = name
        self.attrs: Dict = dict(attrs)
        self.children: List["Span"] = []
        self._lock = _lock
        self.t1: Optional[float] = None
        self.t0 = time.perf_counter()

    def child(self, name: str, **attrs) -> "Span":
        c = Span(name, self._lock, **attrs)
        with self._lock:
            self.children.append(c)
        return c

    def set(self, **attrs) -> "Span":
        with self._lock:
            self.attrs.update(attrs)
        return self

    def end(self, **attrs) -> "Span":
        if attrs:
            self.set(**attrs)
        if self.t1 is None:
            self.t1 = time.perf_counter()
        return self

    @property
    def duration_ms(self) -> float:
        return ((self.t1 if self.t1 is not None else time.perf_counter())
                - self.t0) * 1e3

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc):
        self.end()

    def to_dict(self, base: Optional[float] = None) -> Dict:
        """JSON-friendly node; times are ms offsets from ``base`` (the
        trace root's start) so a dump reads as a timeline."""
        if base is None:
            base = self.t0
        with self._lock:
            children = list(self.children)
            attrs = dict(self.attrs)
        return {
            "name": self.name,
            "start_ms": round((self.t0 - base) * 1e3, 3),
            "dur_ms": round(self.duration_ms, 3),
            "attrs": attrs,
            "children": [c.to_dict(base) for c in children],
        }


class _NullSpan:
    """Shared no-op span: ``child()`` returns itself, so an arbitrarily
    deep instrumented path allocates nothing when tracing is off."""
    __slots__ = ()
    name = "null"
    t0 = 0.0
    t1 = 0.0
    attrs: Dict = {}
    children: List = []
    duration_ms = 0.0

    def child(self, name, **attrs):
        return self

    def set(self, **attrs):
        return self

    def end(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def to_dict(self, base=None):
        return {}


NULL_SPAN = _NullSpan()


_trace_ids = itertools.count(1)


class QueryTrace:
    """One sampled query: a root span plus the wall-clock timestamp the
    export needs. ``finish()`` closes the root and files the trace with
    the owning tracer. ``trace_id`` is a process-unique ordinal so logs
    and structured errors (ClusterSearchError) can name the trace they
    belong to without holding a reference."""

    def __init__(self, name: str, tracer: "Optional[Tracer]" = None,
                 **attrs):
        self._tracer = tracer
        self.trace_id = next(_trace_ids)
        self.wall_time = time.time()
        self._lock = threading.Lock()
        self.root = Span(name, self._lock, **attrs)

    def finish(self, **attrs) -> "QueryTrace":
        self.root.end(**attrs)
        if self._tracer is not None:
            self._tracer._record(self)
        return self

    @property
    def duration_ms(self) -> float:
        return self.root.duration_ms

    def to_dict(self) -> Dict:
        return {"wall_time": self.wall_time, "trace_id": self.trace_id,
                "root": self.root.to_dict(self.root.t0)}

    def well_formed(self) -> bool:
        """Every span ended with t1 >= t0, and every child interval
        nested within its parent's — the property test's invariant."""
        def check(span: Span) -> bool:
            if span.t1 is None or span.t1 < span.t0:
                return False
            for c in span.children:
                if c.t0 < span.t0 or c.t1 is None or c.t1 > span.t1:
                    return False
                if not check(c):
                    return False
            return True
        return check(self.root)


class Tracer:
    """Sampling decision + ring buffer of finished traces.

    ``sample_every=N`` keeps every Nth query starting with the first;
    0 (the default) disables tracing entirely — ``start`` returns None
    and callers fall back to ``NULL_SPAN``.
    """

    def __init__(self, sample_every: int = 0, keep: int = 32):
        self.sample_every = int(sample_every)
        self._lock = threading.Lock()
        self._n = 0
        self.recent: "deque[QueryTrace]" = deque(maxlen=keep)
        self.last_trace: Optional[QueryTrace] = None

    @property
    def enabled(self) -> bool:
        return self.sample_every > 0

    def start(self, name: str, **attrs) -> Optional[QueryTrace]:
        if self.sample_every <= 0:
            return None
        with self._lock:
            n = self._n
            self._n += 1
        if n % self.sample_every:
            return None
        return QueryTrace(name, tracer=self, **attrs)

    def _record(self, trace: QueryTrace) -> None:
        with self._lock:
            self.recent.append(trace)
            self.last_trace = trace

    def export(self) -> List[Dict]:
        """JSON-friendly dump of the retained traces (oldest first)."""
        with self._lock:
            traces = list(self.recent)
        return [t.to_dict() for t in traces]
