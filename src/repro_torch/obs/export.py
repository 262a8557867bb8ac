"""Exporters and the shared post-run summary (DESIGN.md §8.3).

Three consumers, one data source (the ``Obs`` bundle):

- ``write_metrics`` — Prometheus text exposition to a file
  (``search_serve --metrics-out``);
- ``write_traces`` — JSON dump of the tracer's retained ``QueryTrace``
  trees (written next to the metrics file when ``--trace-sample`` is on);
- ``render_summary`` — the one human-readable post-run block every
  ``search_serve`` target (single store, cluster, service-wrapped
  engine) prints, replacing the divergent per-target code paths;
  ``render_trace`` pretty-prints one trace tree for the console.

Everything here only *reads* instruments; nothing in this module is on
a query path.

The file writers are atomic (write a ``.tmp`` sibling, fsync, then
``os.replace`` — the store-manifest publish idiom): a concurrent reader
of ``metrics.prom`` sees the previous complete file or the new one,
never a torn prefix.

A copy of ``repro.obs.export``.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

from . import Obs
from .trace import QueryTrace


def _atomic_write(path: str, text: str) -> None:
    """tmp + fsync + rename, same durability contract as the store
    manifest: readers never observe a partially-written file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_metrics(obs: Obs, path: str, prefix: str = "repro") -> None:
    """Dump the registry in Prometheus text exposition format
    (atomically — scrapers tailing the file never see a torn dump)."""
    _atomic_write(path, obs.registry.to_prometheus(prefix=prefix))


def write_traces(obs: Obs, path: str) -> int:
    """Dump the tracer's retained traces as JSON (atomically);
    returns how many."""
    traces = obs.tracer.export()
    _atomic_write(path, json.dumps(
        {"schema": "repro-traces-v1", "traces": traces}, indent=1))
    return len(traces)


def _fmt_ms(v: float, width: int = 9) -> str:
    """A span duration for the timeline. Sub-0.1 ms spans (an all-
    cache-hit load, a no-op merge) rendered at ms precision collapse to
    ``0.000ms`` — print those in µs so the timeline stays readable."""
    if 0 < abs(v) < 0.1:
        return f"{v * 1e3:>{width}.1f}µs"
    return f"{v:>{width}.3f}ms"


def render_trace(trace: Optional[QueryTrace]) -> str:
    """Indented timeline of one QueryTrace (start offset + duration per
    span, then its attrs) — the README's sample dump."""
    if trace is None:
        return "(no trace sampled)"
    lines: List[str] = []

    def walk(node: dict, depth: int) -> None:
        attrs = " ".join(f"{k}={v}" for k, v in node["attrs"].items())
        lines.append(f"{'  ' * depth}{node['name']:<8} "
                     f"+{_fmt_ms(node['start_ms'], 8)} "
                     f"{_fmt_ms(node['dur_ms'])}  {attrs}".rstrip())
        for child in node["children"]:
            walk(child, depth + 1)

    walk(trace.to_dict()["root"], 0)
    return "\n".join(lines)


def _fmt_labels(labels: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def render_summary(searcher, obs: Optional[Obs] = None,
                   slo_monitor=None) -> str:
    """The unified post-run block: query/stage latency percentiles from
    the registry, rolling-window rates, SLO burn states (when a monitor
    is passed), slab cache state, engine compile traces, and the slow
    query ring — identical shape whichever target ``searcher`` is (the
    resident engine, a FlashSearchSession, a FlashClusterSession, or a
    SearchService wrapping any of them)."""
    if obs is None:
        obs = getattr(searcher, "obs", None)
    lines: List[str] = ["== observability summary =="]
    if obs is None or not getattr(obs, "enabled", False):
        lines.append("observability disabled")
        return "\n".join(lines)

    hists = [(name, labels, m)
             for name, labels, kind, m in obs.registry.items()
             if kind == "histogram" and m.count]
    served = False
    for name, labels, m in hists:
        if name != "query_ms":
            continue
        served = True
        lines.append(
            f"queries[{_fmt_labels(labels)}]: n={m.count} "
            f"p50={m.p50:.2f}ms p95={m.p95:.2f}ms p99={m.p99:.2f}ms")
        w = obs.registry.windowed(name, **labels)
        if w is not None and w.count:
            ws = w.stats()
            lines.append(
                f"  last {w.window_s:g}s: n={ws['count']} "
                f"rate={ws['rate_per_s']:.2f}/s p50={ws['p50']:.2f}ms "
                f"p95={ws['p95']:.2f}ms p99={ws['p99']:.2f}ms")
    if not served:
        # a run that served zero queries still prints a complete,
        # well-formed block — not a bare header (and never a divide)
        lines.append("no queries served")
    if slo_monitor is not None:
        for st in slo_monitor.evaluate():
            gf = ("-" if st.good_fraction is None
                  else f"{st.good_fraction:.4f}")
            lines.append(
                f"slo {st.name}: {st.state} good={gf} "
                f"burn={st.burn_rate:.2f} "
                f"budget={st.budget_remaining:.3f} ({st.detail})")
    stage = [(labels.get("stage", "?"), m) for name, labels, m in hists
             if name == "stage_ms"]
    if stage:
        lines.append("stage latency (ms):")
        for sname, m in stage:
            lines.append(f"  {sname:<14} n={m.count:<6} p50={m.p50:8.3f} "
                         f"p95={m.p95:8.3f} p99={m.p99:8.3f}")
    for name, labels, m in hists:
        if name in ("serve_queue_wait_ms", "cluster_shard_ms"):
            lines.append(
                f"{name}[{_fmt_labels(labels)}]: n={m.count} "
                f"p50={m.p50:.3f}ms p95={m.p95:.3f}ms p99={m.p99:.3f}ms")

    # slab cache: every tier exposes the same cache_stats surface
    cache = getattr(searcher, "slab_cache", None)
    cstats = getattr(searcher, "cache_stats", None)
    if cstats is not None:
        obs.publish_cache(cache)
        extra = (f" bytes={cache.nbytes} entries={len(cache)}"
                 if cache is not None else "")
        lines.append(
            f"slab cache: hit_rate={cstats.hit_rate:.3f} "
            f"hits={cstats.hits} misses={cstats.misses} "
            f"evictions={cstats.evictions}"
            f" invalidations={cstats.invalidations}{extra}")

    # compile traces: one consistent accessor for every target — the
    # engine, both session tiers, and SearchService (via its searcher)
    target = searcher
    cs = getattr(target, "compile_stats", None)
    if cs is None:
        target = getattr(searcher, "searcher", None)
        cs = getattr(target, "compile_stats", None)
    if cs is not None:
        line = f"engine traces: {cs['n_traces']}"
        if "per_shard" in cs:
            line += f" (per-shard max: {cs['per_shard']})"
        reg_traces = obs.registry.counter("engine_compile_traces").value
        line += f" [registry: {reg_traces}]"
        lines.append(line)

    slow = obs.slow_query_log()
    if slow:
        lines.append(f"slow queries (>= {obs.slow_ms:g}ms): {len(slow)}; "
                     "worst:")
        for rec in slow[:3]:
            extras = " ".join(f"{k}={v}" for k, v in rec.items()
                              if k not in ("surface", "wall_ms", "time"))
            lines.append(f"  {rec['wall_ms']:9.2f}ms "
                         f"[{rec['surface']}] {extras}".rstrip())
    return "\n".join(lines)
