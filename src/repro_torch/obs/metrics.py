"""Thread-safe metrics registry: counters, gauges, and fixed-bucket
latency histograms (DESIGN.md §8.1).
A copy of ``repro.obs.metrics``: the two packages keep the same
instruments, names and rules.

The paper's claims are measurements — each pipeline stage (in-storage
filter, decode, match, merge) is timed and bounded — so the repro needs
one place those timings accumulate instead of four ad-hoc stat surfaces.
A ``MetricsRegistry`` is a process-scope (or test-scope) bag of named,
labeled metrics:

    reg.counter("queries_total", surface="store").inc()
    reg.histogram("stage_ms", stage="decode").observe(3.2)
    reg.gauge("slab_cache_bytes").set(cache.nbytes)

Metrics are get-or-create: the first call with a (name, labels) pair
creates the instrument, later calls return the same object, so hot
paths can hold the handle and skip the lookup. Every instrument carries
its own lock (Python ``+=`` is not atomic across bytecodes), which the
16-thread hammer test pins down: no lost increments.

Histograms use fixed upper-bound buckets (defaults tuned for
millisecond latencies) so ``observe`` is O(log buckets) with no
allocation; p50/p95/p99 are extracted by linear interpolation within
the winning bucket, with the observed min/max tightening the open ends.

``to_prometheus()`` renders the standard text exposition format;
``to_dict()`` is the JSON-friendly mirror. ``NULL_REGISTRY`` is the
no-op twin every instrumented path falls back to when observability is
disabled outright (``Obs.disabled()``) — same surface, zero work — so
the overhead knob is a constructor argument, not an if-tree.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

# default latency buckets (milliseconds): half-decade steps from 100us
# to 5s cover every stage this tree times (a cache hit is ~0.1 ms, a
# cold cluster scatter ~1s); +Inf is implicit
DEFAULT_MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)

LabelItems = Tuple[Tuple[str, str], ...]


class HistState(NamedTuple):
    """One atomic read of a histogram: bucket counts (incl. overflow),
    total count, sum, and the observed extremes — everything a torn-free
    render or quantile needs, captured under a single lock acquisition."""
    counts: Tuple[int, ...]
    total: int
    sum: float
    lo: float            # observed min (inf when empty)
    hi: float            # observed max (-inf when empty)


def percentile_from_state(bounds: Tuple[float, ...], state: HistState,
                          q: float) -> float:
    """q in [0, 1] -> quantile interpolated linearly inside the winning
    bucket, with the observed min/max tightening the open-ended first
    and overflow buckets. The one interpolation rule both the lifetime
    ``Histogram`` and the rolling ``WindowedHistogram`` share, so a
    merged-window p99 is directly comparable to the lifetime one."""
    if not state.total:
        return 0.0
    rank = q * state.total
    cum = 0
    for i, c in enumerate(state.counts):
        cum += c
        if not c or cum < rank:
            continue
        lo = bounds[i - 1] if i > 0 else min(state.lo, bounds[0])
        hi = bounds[i] if i < len(bounds) else state.hi
        lo = min(max(lo, state.lo), state.hi)
        hi = max(min(hi, state.hi), lo)
        return lo + (hi - lo) * (rank - (cum - c)) / c
    return state.hi          # all mass below rank (rounding): worst case


def fraction_le_from_state(bounds: Tuple[float, ...], state: HistState,
                           threshold: float) -> float:
    """Fraction of observations <= ``threshold``, interpolating inside
    the straddling bucket (the latency-SLO good-event estimator; 1.0
    when empty — no traffic violates no objective)."""
    if not state.total:
        return 1.0
    if threshold >= state.hi:
        return 1.0
    if threshold < state.lo:
        return 0.0
    cum = 0.0
    for i, c in enumerate(state.counts):
        lo = bounds[i - 1] if i > 0 else min(state.lo, bounds[0])
        hi = bounds[i] if i < len(bounds) else state.hi
        lo = min(max(lo, state.lo), state.hi)
        hi = max(min(hi, state.hi), lo)
        if threshold >= hi:
            cum += c
            continue
        if threshold > lo and hi > lo:
            cum += c * (threshold - lo) / (hi - lo)
        break
    return min(cum / state.total, 1.0)


class Counter:
    """Monotonic counter. ``window`` (attached by the registry) is an
    optional rolling-window twin every ``inc`` forwards to."""
    __slots__ = ("_lock", "_value", "window")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0
        self.window = None

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n
        w = self.window
        if w is not None:
            w.inc(n)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with quantile extraction.

    ``bounds`` are inclusive upper bounds; one overflow (+Inf) bucket is
    appended. Quantiles interpolate linearly inside the winning bucket,
    using the observed min/max to tighten the first and last buckets —
    exact enough for stage attribution (the use case), cheap enough for
    the hot path (one bisect + one lock per observe).

    ``state()`` is the torn-free read: counts, total, sum, min, max
    captured under one lock acquisition, so a /metrics scrape can never
    pair a bucket vector with a count from a different instant.
    ``window`` (attached by the registry) is an optional rolling-window
    twin every ``observe`` forwards to (DESIGN.md §8.4).
    """
    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count",
                 "_min", "_max", "window")

    def __init__(self, buckets: Optional[Tuple[float, ...]] = None):
        bounds = tuple(sorted(buckets or DEFAULT_MS_BUCKETS))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self.window = None

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
        w = self.window
        if w is not None:
            w.observe(v)

    # -- read side -----------------------------------------------------
    def state(self) -> HistState:
        """Everything the read side needs, under ONE lock acquisition."""
        with self._lock:
            return HistState(tuple(self._counts), self._count, self._sum,
                             self._min, self._max)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 1] -> interpolated quantile (0.0 when empty)."""
        return percentile_from_state(self.bounds, self.state(), q)

    def fraction_le(self, threshold: float) -> float:
        """Estimated fraction of observations <= threshold (SLO input)."""
        return fraction_le_from_state(self.bounds, self.state(), threshold)

    @property
    def p50(self) -> float:
        return self.percentile(0.50)

    @property
    def p95(self) -> float:
        return self.percentile(0.95)

    @property
    def p99(self) -> float:
        return self.percentile(0.99)

    def summary(self) -> Dict[str, float]:
        """One JSON-friendly snapshot (the BENCH-row payload), computed
        from a single atomic state read."""
        st = self.state()
        mean = st.sum / st.total if st.total else 0.0
        return {"count": st.total, "sum": round(st.sum, 3),
                "mean": round(mean, 3),
                "p50": round(percentile_from_state(self.bounds, st, .50), 3),
                "p95": round(percentile_from_state(self.bounds, st, .95), 3),
                "p99": round(percentile_from_state(self.bounds, st, .99), 3)}

    def buckets(self) -> List[Tuple[float, int]]:
        """(upper bound, cumulative count) pairs, Prometheus-style."""
        counts = self.state().counts
        out, cum = [], 0
        for bound, c in zip(self.bounds + (math.inf,), counts):
            cum += c
            out.append((bound, cum))
        return out


_EMPTY_STATE = HistState((0,), 0, 0.0, math.inf, -math.inf)


class _NullMetric:
    """Shared no-op instrument: same surface as all three kinds."""
    __slots__ = ()
    value = 0
    count = 0
    sum = 0.0
    mean = 0.0
    p50 = p95 = p99 = 0.0
    window = None
    bounds = (math.inf,)

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def percentile(self, q):
        return 0.0

    def fraction_le(self, threshold):
        return 1.0

    def state(self):
        return _EMPTY_STATE

    def summary(self):
        return {}

    def buckets(self):
        return []


NULL_METRIC = _NullMetric()

_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named, labeled instruments with get-or-create semantics.

    When ``windows`` is on (the default), every counter and histogram
    gets a rolling-window twin (``obs/window.py``) attached at creation
    and forwarded to on each ``inc``/``observe`` — the lifetime
    instrument answers "since process start", the twin answers "over the
    last ``window_s`` seconds" (what SLO burn rates and live dashboards
    need; DESIGN.md §8.4). ``windowed(name, **labels)`` fetches a twin.
    """

    def __init__(self, *, windows: bool = True, window_s: float = 60.0,
                 window_slices: int = 6, clock=None):
        self._lock = threading.Lock()
        # (name, sorted label items) -> (kind, labels dict, instrument)
        self._metrics: Dict[Tuple[str, LabelItems], Tuple[str, Dict, object]] = {}
        self.window_s = float(window_s)
        self.window_slices = int(window_slices)
        self._windows = bool(windows)
        self._clock = clock

    def _attach_window(self, kind: str, metric) -> None:
        if not self._windows:
            return
        from .window import WindowedCounter, WindowedHistogram
        kw = {"window_s": self.window_s, "slices": self.window_slices}
        if self._clock is not None:
            kw["clock"] = self._clock
        if kind == "counter":
            metric.window = WindowedCounter(**kw)
        elif kind == "histogram":
            metric.window = WindowedHistogram(metric.bounds, **kw)

    def _get(self, kind: str, name: str, labels: Dict[str, str],
             **kwargs):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            slot = self._metrics.get(key)
            if slot is None:
                metric = _KINDS[kind](**kwargs)
                self._attach_window(kind, metric)
                slot = (kind, dict(key[1]), metric)
                self._metrics[key] = slot
            elif slot[0] != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {slot[0]}, "
                    f"not {kind}")
            return slot[2]

    def windowed(self, name: str, **labels):
        """The rolling-window twin of an existing counter/histogram, or
        None (unknown metric, gauge, or windows disabled). Never
        creates an instrument — the SLO evaluator must not invent
        series that no hot path feeds."""
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            slot = self._metrics.get(key)
        return getattr(slot[2], "window", None) if slot else None

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels, buckets=buckets)

    # -- introspection / export ----------------------------------------
    def items(self) -> List[Tuple[str, Dict[str, str], str, object]]:
        """(name, labels, kind, instrument), sorted by (name, labels)."""
        with self._lock:
            entries = sorted(self._metrics.items())
        return [(name, dict(labelitems), kind, metric)
                for (name, labelitems), (kind, _, metric) in entries]

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)

    def to_dict(self) -> Dict:
        """JSON-friendly snapshot: name -> [{labels, value|summary}]."""
        out: Dict[str, List] = {}
        for name, labels, kind, metric in self.items():
            entry = {"labels": labels}
            if kind == "histogram":
                entry.update(metric.summary())
            else:
                entry["value"] = metric.value
            out.setdefault(name, []).append(entry)
        return out

    def to_prometheus(self, prefix: str = "repro",
                      include_windows: bool = False) -> str:
        """Standard Prometheus text exposition of every instrument.

        Each histogram is rendered from ONE atomic ``state()`` read, so
        a scrape never sees a ``_count`` inconsistent with its bucket
        vector (the torn-registry hazard the telemetry server's
        ``/metrics`` endpoint must never expose). With
        ``include_windows`` the rolling-window twins are appended as
        ``{name}_window`` gauges labeled with the window length and a
        ``stat`` (p50/p95/p99/count/rate_per_s for histograms,
        total/rate_per_s for counters)."""
        lines: List[str] = []
        window_lines: List[str] = []
        last_name = None
        for name, labels, kind, metric in self.items():
            full = f"{prefix}_{name}" if prefix else name
            if name != last_name:
                lines.append(f"# TYPE {full} {kind}")
                last_name = name
            if kind == "histogram":
                st = metric.state()
                cum = 0
                for bound, c in zip(metric.bounds + (math.inf,), st.counts):
                    cum += c
                    le = "+Inf" if math.isinf(bound) else f"{bound:g}"
                    lines.append(f"{full}_bucket"
                                 f"{_fmt_labels(labels, le=le)} {cum}")
                lines.append(f"{full}_sum{_fmt_labels(labels)} "
                             f"{st.sum:g}")
                lines.append(f"{full}_count{_fmt_labels(labels)} "
                             f"{st.total}")
            else:
                lines.append(f"{full}{_fmt_labels(labels)} "
                             f"{metric.value:g}")
            w = include_windows and getattr(metric, "window", None)
            if w:
                if not window_lines or not window_lines[-1].startswith(
                        f"{full}_window"):
                    window_lines.append(f"# TYPE {full}_window gauge")
                wtag = f"{w.window_s:g}s"
                for stat, v in w.stats().items():
                    window_lines.append(
                        f"{full}_window"
                        f"{_fmt_labels(labels, window=wtag, stat=stat)} "
                        f"{v:g}")
        lines.extend(window_lines)
        return "\n".join(lines) + ("\n" if lines else "")


class _NullRegistry:
    """No-op registry (``Obs.disabled()``): hot paths keep their handle
    pattern, every instrument is the shared ``NULL_METRIC``."""
    __slots__ = ()

    def counter(self, name, **labels):
        return NULL_METRIC

    def gauge(self, name, **labels):
        return NULL_METRIC

    def histogram(self, name, buckets=None, **labels):
        return NULL_METRIC

    def windowed(self, name, **labels):
        return None

    def items(self):
        return []

    def __len__(self):
        return 0

    def to_dict(self):
        return {}

    def to_prometheus(self, prefix="repro", include_windows=False):
        return ""


NULL_REGISTRY = _NullRegistry()


def _fmt_labels(labels: Dict[str, str], **extra) -> str:
    merged = dict(labels, **extra)
    if not merged:
        return ""
    body = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(merged.items()))
    return "{" + body + "}"
