"""Unified observability layer (DESIGN.md §8): metrics registry,
per-query trace spans, and exporters.

``Obs`` bundles the two instruments every tier shares — a
``MetricsRegistry`` (always on; counters and stage-latency histograms
are cheap enough to leave running) and a ``Tracer`` (off by default;
``trace_sample=N`` samples every Nth query into a ``QueryTrace``
tree) — plus a ring buffer of recent query records that
``slow_query_log()`` filters by threshold.

Sessions, routers, services, and pipelines all take ``obs=None`` and
fall back to the process-wide ``default_obs()``, so sharing one
registry across a cluster's shard sessions needs no plumbing, while a
benchmark that wants clean numbers passes its own ``Obs()`` (or
``Obs.disabled()`` to measure the instrumentation floor).

A copy of ``repro.obs`` (``metrics``, ``trace``, ``window``, ``export``,
``slo``, ``server`` and this bundle): numpy and threads, no device work
but ``server``'s ``/debug/profile`` capture (``torch.profiler``). Every
counter and histogram carries a rolling-window twin (``obs/window.py``),
SLO burn states evaluate against those windows (``obs/slo.py``), and
``obs/server.py`` serves the whole bundle over HTTP.
``device_fence=True`` opts the engine into ``torch.cuda.synchronize``
fencing so ``stage_ms`` splits score time into dispatch vs device
(default off: fencing serializes the pipeline).
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .metrics import (DEFAULT_MS_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, NULL_METRIC, NULL_REGISTRY)
from .trace import NULL_SPAN, QueryTrace, Span, Tracer

__all__ = [
    "DEFAULT_MS_BUCKETS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "NULL_METRIC", "NULL_REGISTRY", "NULL_SPAN",
    "Obs", "QueryTrace", "Span", "Tracer", "default_obs",
]

# fields mirrored one-to-one from a per-query SearchStats (or the
# ClusterStats aggregate, which exposes the same names) into counters
_STAT_COUNTERS = ("segments_total", "segments_skipped", "segments_scored",
                  "docs_scored", "pairs_truncated", "memtable_docs",
                  "cache_hits", "cache_misses", "cache_evictions")


class Obs:
    """Registry + tracer + recent-query ring, shared down a tier."""

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 trace_sample: int = 0, slow_ms: float = 250.0,
                 keep_traces: int = 32, keep_queries: int = 256,
                 window_s: float = 60.0, window_slices: int = 6,
                 device_fence: bool = False):
        self.enabled = True
        self.registry = (MetricsRegistry(window_s=window_s,
                                         window_slices=window_slices)
                         if registry is None else registry)
        self.tracer = Tracer(sample_every=trace_sample, keep=keep_traces)
        self.slow_ms = float(slow_ms)
        self.device_fence = bool(device_fence)
        self._queries: deque = deque(maxlen=keep_queries)
        self._q_lock = threading.Lock()

    @classmethod
    def disabled(cls) -> "Obs":
        """The instrumentation floor: null registry, tracing off,
        ``note_query`` a no-op. Used by the storage_bench overhead gate
        to price the always-on half of the layer."""
        obs = cls.__new__(cls)
        obs.enabled = False
        obs.registry = NULL_REGISTRY
        obs.tracer = Tracer(sample_every=0, keep=1)
        obs.slow_ms = math.inf
        obs.device_fence = False
        obs._queries = deque(maxlen=1)
        obs._q_lock = threading.Lock()
        return obs

    # -- query accounting ----------------------------------------------
    def note_query(self, surface: str, wall_ms: float, **info) -> None:
        """Record one finished query: wall-time histogram + the recent
        ring ``slow_query_log`` reads."""
        if not self.enabled:
            return
        self.registry.histogram("query_ms", surface=surface).observe(wall_ms)
        rec = {"surface": surface, "wall_ms": round(float(wall_ms), 3),
               "time": time.time()}
        rec.update(info)
        with self._q_lock:
            self._queries.append(rec)

    def slow_query_log(self, threshold_ms: Optional[float] = None
                       ) -> List[Dict]:
        """Recent queries at least ``threshold_ms`` slow (default: the
        configured ``slow_ms``), slowest first."""
        thr = self.slow_ms if threshold_ms is None else float(threshold_ms)
        with self._q_lock:
            recs = list(self._queries)
        return sorted((r for r in recs if r["wall_ms"] >= thr),
                      key=lambda r: -r["wall_ms"])

    def publish_search_stats(self, stats, *, surface: str) -> None:
        """Mirror one query's SearchStats/ClusterStats deltas into the
        registry (monotonic counters, unlike the per-query dataclass)."""
        if not self.enabled or stats is None:
            return
        reg = self.registry
        reg.counter("queries_total", surface=surface).inc()
        for field in _STAT_COUNTERS:
            v = getattr(stats, field, 0) or 0
            if v:
                reg.counter(field + "_total", surface=surface).inc(int(v))

    def publish_cache(self, cache) -> None:
        """Snapshot a SlabCache's lifetime state into gauges (export
        time only — the cache keeps its own counters)."""
        if not self.enabled or cache is None:
            return
        reg = self.registry
        reg.gauge("slab_cache_bytes").set(cache.nbytes)
        reg.gauge("slab_cache_entries").set(len(cache))
        st = cache.stats_snapshot()
        reg.gauge("slab_cache_hits_lifetime").set(st.hits)
        reg.gauge("slab_cache_misses_lifetime").set(st.misses)
        reg.gauge("slab_cache_evictions_lifetime").set(st.evictions)
        reg.gauge("slab_cache_invalidations_lifetime").set(st.invalidations)


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[Obs] = None


def default_obs() -> Obs:
    """Process-wide fallback bundle (created on first use)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = Obs()
        return _DEFAULT
