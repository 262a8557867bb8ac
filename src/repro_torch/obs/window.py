"""Rolling-window instruments: time-decaying counters and histograms
(DESIGN.md §8.4).
A copy of ``repro.obs.window``: the two packages keep the same
instruments, names and rules.

The lifetime instruments in ``metrics.py`` answer "since process
start"; an operator (and the SLO evaluator, ``obs/slo.py``) needs "over
the last minute". Both windowed kinds keep a ring of ``slices``
fixed-size sub-accumulators, each covering ``window_s / slices``
seconds of wall clock: an observe lands in the slice owning the current
instant, and advancing time *lazily* rotates the ring — the slice(s)
that fell out of the window are zeroed on the next observe or read, so
there is no rotation thread and an idle instrument costs nothing.

The window therefore covers between ``(slices-1)/slices * window_s``
and ``window_s`` seconds of data (standard ring approximation: the
oldest live slice is partially expired). Reads merge the live slices
into one :class:`~repro_torch.obs.metrics.HistState`, so the merged-window
p50/p95/p99 use the *same* bucket-interpolation rule as the lifetime
histogram (``percentile_from_state``) and the two are directly
comparable.

Lock discipline matches ``metrics.py``: one lock per instrument, held
for the counter bump / slice merge only — never across a clock read by
callers, never nested. The 16-thread hammer test pins down that
concurrent ``observe`` + rotation loses no events while the window
covers them.

Windowed mins/maxes are per-slice, so the merged extremes decay with
the window — a latency spike ages out of the p99 after ``window_s``
seconds instead of pinning it forever (the reason lifetime histograms
cannot drive admission control; ROADMAP "tail-latency SLOs").
"""
from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Dict, Optional, Tuple

from .metrics import (DEFAULT_MS_BUCKETS, HistState, fraction_le_from_state,
                      percentile_from_state)


class _Ring:
    """Shared rotation bookkeeping: slice index of 'now', lazy zeroing.
    Subclass under the instrument lock only."""

    def __init__(self, window_s: float, slices: int, clock):
        if window_s <= 0 or slices < 1:
            raise ValueError("window_s must be > 0 and slices >= 1")
        self.window_s = float(window_s)
        self.n_slices = int(slices)
        self._slice_s = self.window_s / self.n_slices
        self.clock = clock
        self._head = 0                       # ring index of current slice
        self._cur = int(clock() / self._slice_s)   # absolute slice number

    def _advance_locked(self) -> None:
        """Zero every slice the clock has moved past; caller holds the
        instrument lock. O(slices) worst case, O(1) amortized."""
        k = int(self.clock() / self._slice_s)
        if k <= self._cur:                   # same slice (monotonic clock)
            return
        for _ in range(min(k - self._cur, self.n_slices)):
            self._head = (self._head + 1) % self.n_slices
            self._clear_slice(self._head)
        self._cur = k

    def _clear_slice(self, i: int) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class WindowedCounter(_Ring):
    """Event count over the trailing window; ``rate_per_s`` divides by
    the window length (the scrape-friendly QPS estimator)."""

    def __init__(self, window_s: float = 60.0, slices: int = 6,
                 clock=time.monotonic):
        self._lock = threading.Lock()
        self._counts = [0] * int(slices)
        super().__init__(window_s, slices, clock)

    def _clear_slice(self, i: int) -> None:
        self._counts[i] = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._advance_locked()
            self._counts[self._head] += n

    def total(self) -> int:
        with self._lock:
            self._advance_locked()
            return sum(self._counts)

    def rate_per_s(self) -> float:
        return self.total() / self.window_s

    def stats(self) -> Dict[str, float]:
        t = self.total()
        return {"total": t, "rate_per_s": round(t / self.window_s, 6)}


class _HistSlice:
    __slots__ = ("counts", "sum", "count", "lo", "hi")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.clear()

    def clear(self):
        for i in range(len(self.counts)):
            self.counts[i] = 0
        self.sum = 0.0
        self.count = 0
        self.lo = math.inf
        self.hi = -math.inf


class WindowedHistogram(_Ring):
    """Fixed-bucket histogram over the trailing window. Same bucket
    bounds and quantile interpolation as the lifetime ``Histogram`` it
    twins (the registry passes the parent's ``bounds`` in), so
    ``p99`` here is the rolling analogue of the lifetime ``p99``."""

    def __init__(self, buckets: Optional[Tuple[float, ...]] = None,
                 window_s: float = 60.0, slices: int = 6,
                 clock=time.monotonic):
        self._lock = threading.Lock()
        self.bounds = tuple(sorted(buckets or DEFAULT_MS_BUCKETS))
        self._slices = [_HistSlice(len(self.bounds) + 1)
                        for _ in range(int(slices))]
        super().__init__(window_s, slices, clock)

    def _clear_slice(self, i: int) -> None:
        self._slices[i].clear()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._advance_locked()
            s = self._slices[self._head]
            s.counts[i] += 1
            s.sum += v
            s.count += 1
            if v < s.lo:
                s.lo = v
            if v > s.hi:
                s.hi = v

    # -- read side -----------------------------------------------------
    def state(self) -> HistState:
        """Merged live slices as one atomic HistState (same shape the
        lifetime histogram's ``state()`` returns)."""
        with self._lock:
            self._advance_locked()
            counts = [0] * (len(self.bounds) + 1)
            total = 0
            sm = 0.0
            lo, hi = math.inf, -math.inf
            for s in self._slices:
                if not s.count:
                    continue
                for i, c in enumerate(s.counts):
                    counts[i] += c
                total += s.count
                sm += s.sum
                lo = min(lo, s.lo)
                hi = max(hi, s.hi)
            return HistState(tuple(counts), total, sm, lo, hi)

    @property
    def count(self) -> int:
        return self.state().total

    def percentile(self, q: float) -> float:
        return percentile_from_state(self.bounds, self.state(), q)

    def fraction_le(self, threshold: float) -> float:
        """Fraction of windowed observations <= threshold (1.0 when the
        window is empty: no traffic violates no latency objective)."""
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

    def stats(self) -> Dict[str, float]:
        """The gauge payload the /metrics window section renders."""
        st = self.state()
        mean = st.sum / st.total if st.total else 0.0
        return {
            "count": st.total,
            "rate_per_s": round(st.total / self.window_s, 6),
            "mean": round(mean, 6),
            "p50": round(percentile_from_state(self.bounds, st, .50), 6),
            "p95": round(percentile_from_state(self.bounds, st, .95), 6),
            "p99": round(percentile_from_state(self.bounds, st, .99), 6),
        }
