"""FlashSearchSession — end-to-end search over a FlashStore (DESIGN.md §3.4).

Wires the storage tier into the engine the way the paper wires flash
slices into accelerator kernels:

    FlashStore segments
        -> Planner: filter verdicts + slab sources  (§4.1)
        -> execute_plan: SlabCache hits (§4.2) + Prefetcher disk
           decodes (§3.3), cache-first scan order
        -> PatternSearchEngine.search_streaming (score + merge top-k)

Every surviving segment becomes one fixed-shape slab on the card (padded
to the store's largest segment) so the whole stream launches at one
shape. Hot segments stay decoded and resident on the card in the
byte-budgeted slab cache, so steady-state queries skip the disk read,
the decode, and the upload entirely — warm results are bit-identical to
cold ones. ``last_stats`` reports how much the filter pruned (the
skip-rate is the storage tier's headline metric) plus the cache
hit/miss/eviction counters.

The port of ``repro.storage.session``: ``device`` (the CUDA card unless
the caller passes ``device="cpu"``, ``repro_torch.device``) or ``ctx``
(a mesh, ``repro_torch.distributed.MeshCtx``) say where it scores, and
the backend is one of the port's
(``gpu`` by default: B1; ``gpu_packed``: B2; ``gpu_fused``: B3 through
``put_stream_slab``; ``torch``: the gather path).

On a mesh every rank runs its own session over the same store, in
lockstep with the same queries: each decodes every surviving segment,
uploads its row block (slabs pad to a multiple of the mesh rows) and
scans in manifest order, so the ranks reduce the same slab together.
The serving tier and the write path drive one process's threads on its
own clock and cannot keep ranks in lockstep: ``service``, ``submit``
and ``enable_ingest`` raise ``NotImplementedError`` there (ROADMAP A8.6).

With ``enable_ingest()`` the session also becomes a *live* writer
surface (DESIGN.md §6): ``append`` routes documents through a
write-ahead log + memtable, and every search scores an atomic snapshot
— the manifest segments, sealed deltas, and memtable captured at the
moment the query (or its coalesced batch) starts scoring — so results
are bit-identical to a from-scratch store holding the same documents,
and background seals/compactions never perturb an in-flight query.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.paper_search import SearchConfig
from repro_torch.core.engine import PatternSearchEngine, SearchResult
from repro_torch.device import DeviceLike
from repro_torch.distributed.meshctx import MeshCtx, refuse_mesh
from repro_torch.obs import NULL_REGISTRY, NULL_SPAN, Obs, default_obs
from repro_torch.serve.api import (Query, QueryOptions, QueryStats, SearchResponse,
                             coerce_request, truncate_k)
from repro_torch.serve.session_surface import ServingSessionMixin
from repro_torch.storage.memo import MemoCache, MemoStats, memo_key
from repro_torch.storage.plan import (DEFAULT_APPROX_MIN_DOCS, MODE_EXACT,
                                Planner, execute_plan)
from repro_torch.storage.slabcache import CacheStats, SlabCache
from repro_torch.storage.store import FlashStore


@dataclasses.dataclass
class SearchStats:
    segments_total: int = 0
    segments_skipped: int = 0
    segments_scored: int = 0
    docs_scored: int = 0
    pairs_truncated: int = 0
    memtable_docs: int = 0     # of docs_scored, how many came from the
                               # live memtable (0 without ingest)
    cache_hits: int = 0        # slab-cache counters for this query
    cache_misses: int = 0      # (DESIGN.md §4.2); all zero when the
    cache_evictions: int = 0   # cache is disabled
    filter_fp_segments: int = 0  # scored segments with zero overlap —
                               # the vocab filter passed them anyway
                               # (Bloom false positives made visible)
    approx_segments: int = 0   # segments scored via the posting-
                               # candidate + exact-re-rank tier (§15)
    candidates: int = 0        # candidate docs gathered across them
    memo_hits: int = 0         # 1 when this result came from the
                               # recurrent-query memo cache

    @property
    def skip_rate(self) -> float:
        return ((self.segments_skipped or 0) / self.segments_total
                if self.segments_total else 0.0)

    @property
    def cache_hit_rate(self) -> float:
        # hardened against both the zero-slab query (every segment
        # filter-skipped: zero probes -> 0.0, never a ZeroDivisionError)
        # and None-valued fields from a shard that reported partial
        # stats (e.g. its cache disabled) — see also ClusterStats._sum
        hits = self.cache_hits or 0
        probes = hits + (self.cache_misses or 0)
        return hits / probes if probes else 0.0


class FlashSearchSession(ServingSessionMixin):
    def __init__(self, store: FlashStore, cfg: SearchConfig,
                 device: DeviceLike = None, backend: str = "gpu",
                 use_filter: bool = True, prefetch_depth: int = 2,
                 slab_cache: Optional[SlabCache] = None,
                 cache_bytes: Optional[int] = None,
                 obs: Optional[Obs] = None,
                 mode: str = MODE_EXACT, candidates: int = 0,
                 approx_min_docs: int = DEFAULT_APPROX_MIN_DOCS,
                 memo: Optional[MemoCache] = None, memo_entries: int = 0,
                 *, ctx: Optional[MeshCtx] = None):
        """``slab_cache`` shares an existing cache (the cluster router
        passes one per-cluster instance); otherwise ``cache_bytes``
        sizes a private one (None = default budget, 0 = disabled).
        ``obs`` shares an observability bundle (DESIGN.md §8); None
        falls back to the process-wide ``default_obs()``.

        ``mode`` picks the session-default scoring tier (§15):
        ``exact`` (the default — every path bit-identical to the
        pre-approx repo), ``approx`` (posting-candidate + exact
        re-rank), or ``auto`` (approx once the view holds at least
        ``approx_min_docs`` docs). ``candidates`` is the default
        per-segment top-C pool (0 = 4 * cfg.top_k). A per-query
        ``QueryOptions.mode/candidates/recall_target`` overrides both.
        ``memo``/``memo_entries`` attach the recurrent-query memo cache
        (shared instance wins; entries > 0 sizes a private one; the
        default is off). ``device`` defaults to the CUDA card and
        raises without one (``repro_torch.device.resolve``); ``ctx``
        scores on a mesh instead, one rank's share in this process."""
        self.store = store
        self.cfg = cfg
        self.use_filter = use_filter
        self.prefetch_depth = prefetch_depth
        self.obs = obs if obs is not None else default_obs()
        if store.vocab_size > cfg.vocab_size:
            # same invariant the resident engine constructor enforces:
            # out-of-range word ids would silently scatter out of bounds
            raise ValueError(
                f"store vocab_size {store.vocab_size} exceeds "
                f"cfg.vocab_size {cfg.vocab_size}")
        self.engine = PatternSearchEngine(None, cfg, device, backend,
                                          obs=self.obs, ctx=ctx)
        self.ctx = self.engine.ctx
        rows = self.ctx.dp_size
        self.slab_cache = SlabCache.resolve(slab_cache, cache_bytes)
        if self.slab_cache is not None:
            store.register_cache(self.slab_cache)
        self._planner = Planner(nnz_pad=cfg.nnz_pad, rows=rows,
                                use_filter=use_filter, cache=self.slab_cache,
                                fmt=self.engine.slab_fmt, mode=mode,
                                candidates=(candidates if candidates > 0
                                            else 4 * cfg.top_k),
                                approx_min_docs=approx_min_docs,
                                lockstep=self.ctx.size > 1)
        self._memo = memo if memo is not None else (
            MemoCache(memo_entries) if memo_entries > 0 else None)
        self.last_stats = SearchStats()
        self._ingest = None
        # one launch shape for every slab: largest segment, mesh-aligned
        self._slab_docs = -(-max(store.max_segment_docs, 1) // rows) * rows
        self._init_serving()

    # -- live ingestion (DESIGN.md §6) ---------------------------------
    def enable_ingest(self, **knobs) -> "IngestPipeline":
        """Attach a write path (WAL + memtable + background compactor)
        to this session's store and replay any WAL tail a crash left
        behind. ``knobs`` are ``repro_torch.ingest.IngestConfig``
        fields. Idempotent; returns the pipeline."""
        from repro_torch.ingest import IngestConfig, IngestPipeline
        refuse_mesh(self.ctx, "the write path (enable_ingest)")
        if self._ingest is None:
            self._ingest = IngestPipeline(self.store, IngestConfig(**knobs),
                                          obs=self.obs)
        return self._ingest

    @property
    def ingest(self) -> Optional["IngestPipeline"]:
        return self._ingest

    def append(self, doc_id: int, pairs: Sequence[Tuple[int, int]]) -> int:
        """Durably append one document ([(word, count), ...]) to the live
        store; it is searchable by the next query. Requires
        ``enable_ingest()``. Returns the WAL sequence number."""
        if self._ingest is None:
            raise RuntimeError(
                "append() needs enable_ingest() first — the session is "
                "read-only until a write path is attached")
        return self._ingest.append(doc_id, pairs)

    def flush_ingest(self) -> int:
        """Seal the memtable into delta segments now (0 without ingest)."""
        return self._ingest.seal() if self._ingest is not None else 0

    # ------------------------------------------------------------------
    def search(self, query, q_vals=None, *,
               options: Optional[QueryOptions] = None, _span=None):
        """Public search surface. Typed form — ``search(Query(ids,
        vals), options=QueryOptions(...))`` — returns a
        ``SearchResponse``; positional ``search(q_ids, q_vals)`` arrays
        remain as a deprecation shim returning the bare
        ``SearchResult`` (``serve/api.py``). A single store has no
        shards to gather, so of the scheduling options only ``k``
        applies here; deadlines act in the coalescing service's queue
        (serve/batcher.py)."""
        q, options = coerce_request(query, q_vals, options,
                                    surface="FlashSearchSession.search")
        res = self.search_typed(q, options=options, _span=_span)
        if options is None:
            return res
        return SearchResponse(truncate_k(res, options.k), QueryStats(
            deadline_ms=options.deadline_ms, tenant=options.tenant))

    def search_typed(self, query: Query,
                     options: Optional[QueryOptions] = None, *,
                     _span=None) -> SearchResult:
        """Query rows [L, Qn] (pad < 0) -> global top-k over the store
        (plus, with ingest enabled, the sealed deltas and memtable of an
        atomic snapshot taken now). Always returns the raw
        ``SearchResult`` — wrapping/truncation belong to the public
        ``search`` shim.

        ``_span`` is the observability hook for nesting callers (the
        cluster router hands each shard session a child span of the
        cluster trace): when set, this query joins the parent's trace
        and the parent owns the query-level accounting."""
        q_ids, q_vals = query.rows()
        # the wall clock only matters when this call owns the query-level
        # accounting AND the bundle is live (Obs.disabled() floor: zero
        # clock reads on the whole path, asserted by test_obs_disabled)
        timed = self.obs.enabled and _span is None
        t0 = time.perf_counter() if timed else 0.0
        trace = None
        if _span is None:
            trace = self.obs.tracer.start("query", surface="store",
                                          L=int(q_ids.shape[0]))
            span = trace.root if trace is not None else NULL_SPAN
        else:
            span = _span
        mode, cand = self._query_knobs(options)
        try:
            if self._ingest is None:
                res = self._memo_or_search(self.store, None, q_ids, q_vals,
                                           span, mode, cand)
            else:
                snap = self._ingest.capture()
                try:
                    res = self._memo_or_search(snap, snap, q_ids, q_vals,
                                               span, mode, cand)
                finally:
                    snap.close()
        except BaseException:
            if _span is None:
                # the availability-SLO bad-event stream (§8.4); nested
                # calls leave the error to the router's cluster counter
                self.obs.registry.counter(
                    "query_errors_total", surface="store").inc()
            raise
        finally:
            if trace is not None:
                trace.finish()
        if timed:
            # nested (per-shard) calls skip this: the router publishes
            # the cluster aggregate, so counting here would double it
            st = self.last_stats
            self.obs.note_query(
                "store", (time.perf_counter() - t0) * 1e3,
                segments_scored=st.segments_scored,
                segments_skipped=st.segments_skipped,
                cache_hits=st.cache_hits, docs_scored=st.docs_scored)
            self.obs.publish_search_stats(st, surface="store")
        return res

    def _query_knobs(self, options: Optional[QueryOptions]):
        """Resolve the per-query (mode, candidates) overrides; None
        means the session (Planner) default applies. A bare
        ``recall_target`` maps to a pool multiplier — the closer to
        1.0, the wider the candidate pool the posting tier keeps."""
        mode = options.mode if options is not None else None
        cand = options.candidates if options is not None else None
        if (cand is None and options is not None
                and options.recall_target is not None):
            mult = max(4.0, 2.0 / max(1.0 - options.recall_target, 0.01))
            cand = int(np.ceil(self.cfg.top_k * mult))
        return mode, cand

    def _memo_or_search(self, view, snap, q_ids, q_vals, span,
                        mode, cand) -> SearchResult:
        """Memo-cache wrapper around ``_search_view`` (§15.3). The key
        is derived from the *captured* view's memo_state — generation
        and memtable fingerprint frozen under the snapshot lock — so a
        concurrent append/seal can never alias a stale entry onto the
        new view; the bumped state is simply a different key."""
        memo = self._memo
        if memo is None:
            return self._search_view(view, snap, q_ids, q_vals, span,
                                     mode=mode, candidates=cand)
        eff_mode = mode if mode is not None else self._planner.mode
        eff_cand = cand if cand is not None else self._planner.candidates
        key = memo_key(view.cache_token, view.memo_state,
                       self.engine.slab_fmt, self.cfg.top_k,
                       eff_mode, eff_cand, q_ids, q_vals)
        hit = memo.get(key)
        if hit is not None:
            res, st = hit
            self.last_stats = dataclasses.replace(st, memo_hits=1)
            span.set(memo_hit=True)
            return res
        res = self._search_view(view, snap, q_ids, q_vals, span,
                                mode=mode, candidates=cand)
        memo.put(key, (res, dataclasses.replace(self.last_stats)))
        return res

    def _search_view(self, view, snap, q_ids: np.ndarray,
                     q_vals: np.ndarray, span=NULL_SPAN, *,
                     mode=None, candidates=None) -> SearchResult:
        """Score one segment view (a FlashStore or an ingest Snapshot;
        ``snap`` carries the memtable when the view is a snapshot):
        plan, then run the shared executor (DESIGN.md §4.1)."""
        reg = self.obs.registry
        timed = not (reg is NULL_REGISTRY and span is NULL_SPAN)
        pspan = span.child("plan")
        t0 = time.perf_counter() if timed else 0.0
        plan = self._planner.plan(view, q_ids, snap, mode=mode,
                                  candidates=candidates)
        if timed:
            reg.histogram("stage_ms", stage="plan").observe(
                (time.perf_counter() - t0) * 1e3)
        pspan.end(segments_total=plan.segments_total,
                  skipped=len(plan.skipped), cached=plan.n_cached,
                  disk=plan.n_disk,
                  skipped_names=plan.skipped[:16])
        self._slab_docs = plan.slab_docs
        stats = SearchStats(segments_total=plan.segments_total,
                            segments_skipped=len(plan.skipped),
                            segments_scored=len(plan.steps))
        self.last_stats = stats
        return execute_plan(self.engine, view, plan, q_ids, q_vals,
                            stats=stats, cache=self.slab_cache,
                            prefetch_depth=self.prefetch_depth,
                            span=span, registry=reg)

    @property
    def cache_stats(self) -> Optional[CacheStats]:
        """A locked point-in-time snapshot of the lifetime slab-cache
        counters (shared across every sharer of the cache), or None when
        the cache is disabled. A snapshot, not the live object: the
        counters mutate under the cache lock mid-query, so a lock-free
        read could pair hits and misses from different moments."""
        return (self.slab_cache.stats_snapshot()
                if self.slab_cache is not None else None)

    @property
    def compile_stats(self) -> dict:
        """The engine's launch-shape telemetry (distinct launch keys),
        surfaced here as in the reference (DESIGN.md §8.3)."""
        return self.engine.compile_stats

    @property
    def last_trace(self):
        """Most recent sampled QueryTrace (None unless the session's
        ``obs`` was built with ``trace_sample`` > 0)."""
        return self.obs.tracer.last_trace

    @property
    def memo_stats(self) -> Optional[MemoStats]:
        """Lifetime memo-cache counters (None when the memo is off)."""
        return (self._memo.stats_snapshot()
                if self._memo is not None else None)

    def _close_resources(self):
        # service/submit/close lifecycle comes from ServingSessionMixin,
        # whose close() guarantees this runs at most once
        if self._memo is not None:
            self._memo.drop_store(self.store.cache_token)
        if self.slab_cache is not None:
            # drop the store's entries only when the *last* session
            # sharing this (store, cache) pair detaches — another live
            # session's warm set must not be wiped from under it
            if self.store.unregister_cache(self.slab_cache):
                self.slab_cache.drop_store(self.store.cache_token)
        if self._ingest is not None:
            self._ingest.close()
            self._ingest = None
        self.store.close()
