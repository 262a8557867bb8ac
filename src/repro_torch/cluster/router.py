"""ShardRouter — scatter/gather top-k over a ShardedStore
(DESIGN.md §5.2–§5.3).

One coalesced ``[L, Qn]`` query batch fans out to every shard on a
thread pool; each shard is a full FlashSearchSession (its own vocab
filters, prefetcher, and L-bucket compile cache — the per-slice
accelerator of the paper, untouched), reporting only its ``[L, k]``
candidates. The gather side folds shard candidates through the engine's
``_merge_results`` in shard order, so the cluster result is bit-identical
to a single-store scan of the union corpus: scoring is per-document,
the merge is deterministic, and duplicate doc ids keep their
best-scoring entry.

Replicas are the fault layer (the fail-over mirror of
``distributed/fault.py``'s requeue): each shard holds ``replicas``
byte-wise independent copies; a query tries replica 0 and a replica
that raises is retried on the next one within the same query — killing
a replica mid-run degrades latency, never correctness. A failed
replica is health-marked *down* (kept out of rotation) only once a
sibling succeeds on the same query, which localizes the fault to the
replica rather than the query. Only when every replica of a shard
fails does the query raise ``ClusterSearchError`` — and then nothing
is marked, so one malformed request cannot brick the cluster.

PR 9 makes the gather deadline-aware (DESIGN.md §7.3): a query carrying
``QueryOptions(deadline_ms=..., allow_partial=True)`` stops waiting on
stragglers at its budget and returns the merged top-k of the shards
that responded, flagged ``partial=True`` with the missing shard list in
``last_stats`` — bit-identical to the full gather whenever every shard
responds in time, because the merge still folds in shard order over
exactly the same per-shard candidates. Replica *hedging* attacks the
straggler before the budget does: when a replica attempt outlives the
straggler threshold (a percentile of the rolling-window
``cluster_shard_ms`` distribution — serve/hedging.py), the same query
fires at the next replica and the first result wins; replicas are
byte-identical, so a hedged result is still bit-identical. Abandoned
and losing attempts run to completion on their executor; per-replica
session locks serialize them against subsequent queries, so the
stateful FlashSearchSession is never raced.

A copy of ``repro.cluster.router`` for one CUDA card. ``device`` (the
card unless the caller passes ``device="cpu"``) goes to every shard
session, and so does ``backend`` (``gpu`` by default). Several threads
now launch kernels and upload slabs at once: the shard pool's workers,
each shard session's prefetch loader (synchronous uploads from pageable
memory), the hedge threads of ``SpawnExecutor``, and an abandoned
partial-gather straggler or hedge loser, which keeps scoring until it
ends. All of them launch on the card's current stream, the default
stream, and no stream or event is added: device work serializes in
launch order, and only host work (plan, decode, padding, top-k folds on
the host, the merge) overlaps. Every launch and copy of one attempt
stays in its own thread's program order on that stream, so a result
does not depend on which thread launched first, and concurrent and
hedged results equal serial ones bit for bit. ``close()`` joins the
hedge threads before it closes any shard session, so no late attempt
scores on slabs that were dropped.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cluster.store import ShardedStore
from repro_torch.configs.paper_search import SearchConfig
from repro_torch.core.engine import SearchResult, _merge_results
from repro_torch.device import DeviceLike, resolve
from repro_torch.obs import NULL_SPAN, Obs, default_obs
from repro_torch.serve.api import (Query, QueryOptions, QueryStats,
                                   SearchResponse, coerce_request,
                                   truncate_k)
from repro_torch.serve.hedging import HedgePolicy, SpawnExecutor, run_hedged
from repro_torch.storage.memo import MemoCache
from repro_torch.storage.plan import DEFAULT_APPROX_MIN_DOCS
from repro_torch.storage.session import FlashSearchSession, SearchStats
from repro_torch.storage.slabcache import CacheStats, SlabCache

log = logging.getLogger(__name__)


class ClusterSearchError(RuntimeError):
    """Every replica of one shard failed the query (or no replica was
    in rotation to take it). Carries structured context so the partial
    and hedged paths — and operators reading logs — can attribute the
    failure: ``shard``, ``replica_errors`` (replica index -> exception
    summary), and the ``trace_id`` of the sampled cluster trace (None
    when this query wasn't sampled)."""

    def __init__(self, msg: str, *, shard: Optional[int] = None,
                 replica_errors: Optional[Dict[int, str]] = None,
                 trace_id: Optional[int] = None):
        super().__init__(msg)
        self.shard = shard
        self.replica_errors = dict(replica_errors or {})
        self.trace_id = trace_id


@dataclasses.dataclass
class ClusterStats:
    """Aggregate of the per-shard SearchStats for the last query batch.
    ``per_shard[s]`` is None until shard s has served a query.
    ``failovers`` snapshots the router's *lifetime* count of replicas
    taken out of rotation (confirmed failovers plus manual
    ``mark_down`` calls), not a per-batch figure. The scheduling fields
    (DESIGN.md §7.3) are per-batch: ``partial``/``shards_missing``
    record a deadline-bound gather that returned without every shard
    (a missing shard's ``per_shard`` slot stays None), ``hedges``/
    ``hedge_wins`` count straggler hedges fired and won."""
    per_shard: List[Optional[SearchStats]]
    failovers: int = 0
    partial: bool = False
    shards_missing: Tuple[int, ...] = ()
    hedges: int = 0
    hedge_wins: int = 0

    def _sum(self, field: str) -> int:
        # `or 0` tolerates shards reporting partial stats (e.g. a
        # replica built with its cache disabled leaves cache fields
        # None-ish) — the aggregate must never raise on a healthy batch
        return sum(int(getattr(st, field, 0) or 0)
                   for st in self.per_shard if st is not None)

    @property
    def segments_total(self) -> int:
        return self._sum("segments_total")

    @property
    def segments_skipped(self) -> int:
        return self._sum("segments_skipped")

    @property
    def segments_scored(self) -> int:
        return self._sum("segments_scored")

    @property
    def docs_scored(self) -> int:
        return self._sum("docs_scored")

    @property
    def pairs_truncated(self) -> int:
        return self._sum("pairs_truncated")

    @property
    def memtable_docs(self) -> int:
        return self._sum("memtable_docs")

    @property
    def cache_hits(self) -> int:
        return self._sum("cache_hits")

    @property
    def cache_misses(self) -> int:
        return self._sum("cache_misses")

    @property
    def cache_evictions(self) -> int:
        return self._sum("cache_evictions")

    @property
    def filter_fp_segments(self) -> int:
        """Scored-but-zero-overlap segments across every shard — the
        cluster-wide filter false-positive count for the last batch."""
        return self._sum("filter_fp_segments")

    @property
    def approx_segments(self) -> int:
        return self._sum("approx_segments")

    @property
    def candidates(self) -> int:
        return self._sum("candidates")

    @property
    def memo_hits(self) -> int:
        return self._sum("memo_hits")

    @property
    def skip_rate(self) -> float:
        """Aggregate skip-rate across every shard's segments."""
        total = self.segments_total
        return self.segments_skipped / total if total else 0.0

    @property
    def cache_hit_rate(self) -> float:
        """Aggregate slab-cache hit rate across every shard's probes
        for the last batch (DESIGN.md §4.2). 0.0 when no shard probed
        the cache at all (every segment filter-skipped, or caches
        disabled) — never a division error."""
        probes = self.cache_hits + self.cache_misses
        return self.cache_hits / probes if probes else 0.0


class ShardRouter:
    """Not thread-safe for concurrent ``search`` calls (each shard
    session is stateful); route concurrency through
    ``FlashClusterSession.submit`` like the single-store session."""

    def __init__(self, store: ShardedStore, cfg: SearchConfig, *,
                 device: DeviceLike = None,
                 backend: str = "gpu", use_filter: bool = True,
                 prefetch_depth: int = 2,
                 max_workers: Optional[int] = None,
                 slab_cache: Optional[SlabCache] = None,
                 cache_bytes: Optional[int] = None,
                 obs: Optional[Obs] = None,
                 hedge_policy: Optional[HedgePolicy] = None,
                 mode: str = "exact", candidates: int = 0,
                 approx_min_docs: Optional[int] = None,
                 memo_entries: int = 0):
        self.store = store
        self.cfg = cfg
        # resolved now, so a router without a card raises at once, not
        # at the first query's lazily opened shard session
        self.device = resolve(device)
        self.backend = backend
        self.use_filter = use_filter
        self.prefetch_depth = prefetch_depth
        # approximate-tier defaults for every shard session (§15): each
        # shard generates + exactly re-ranks its own candidate pool, and
        # the gather merges the per-shard exact top-k — equivalent to
        # merging the pools first, because re-rank scores are exact and
        # the global top-k of a union is the top-k of per-shard top-ks
        self.mode = mode
        self.candidates = candidates
        self.approx_min_docs = approx_min_docs
        # one memo cache for the whole cluster: shard stores have
        # distinct cache tokens, so entries can never alias across
        # shards, and the budget is shared like the slab cache's
        self._memo = (MemoCache(memo_entries) if memo_entries > 0
                      else None)
        # one observability bundle for the whole cluster (DESIGN.md §8):
        # shard sessions share it, so their stage histograms aggregate,
        # while query-level accounting stays with the router
        self.obs = obs if obs is not None else default_obs()
        # one device slab cache for the whole cluster (DESIGN.md §4.2):
        # every shard-replica session shares the byte budget, so a hot
        # shard can hold more resident slabs than a cold one
        self.slab_cache = SlabCache.resolve(slab_cache, cache_bytes)
        n, r = store.n_shards, store.replicas
        self._sessions: List[List[Optional[FlashSearchSession]]] = \
            [[None] * r for _ in range(n)]
        self._down: List[List[bool]] = [[False] * r for _ in range(n)]
        # per-(shard, replica) locks: a shard session is stateful, so a
        # hedge loser or an abandoned partial-gather straggler still
        # running must serialize against the next query's attempt on
        # the same replica (DESIGN.md §7.3)
        self._sess_locks: List[List[threading.Lock]] = \
            [[threading.Lock() for _ in range(r)] for _ in range(n)]
        self._lock = threading.Lock()    # session creation + health marks
        # the router's default straggler policy; per-query
        # QueryOptions.hedging overrides (False pins off, True forces
        # on with a default policy when none is configured)
        self.hedge_policy = hedge_policy
        # hedge attempts run on their own lazy spawn-per-attempt
        # executor: launching them on self._pool could deadlock (every
        # worker blocked in a gather waiting for a hedge that can't get
        # a thread), and a *bounded* hedge pool starves — an abandoned
        # loser sleeping inside a straggler holds a worker, so the next
        # query's hedge would queue behind the very straggler it was
        # meant to outrun
        self._hedge_pool: Optional[SpawnExecutor] = None
        # default concurrency adapts to the host: the reference found
        # concurrent jax CPU dispatch *loses* to serial below ~4 cores
        # (client contention), so small hosts get one worker (serialized
        # shards, still correct) and many-core hosts fan out up to one
        # thread per shard. On the card the formula is kept: device work
        # serializes on the one stream whatever the worker count, so what
        # the workers overlap is each shard's host work (plan, decode and
        # pad in its loader, top-k folds, D2H waits), which shares the
        # interpreter lock. 4 shards on an 8-core host get 4 workers: on
        # the H100 they load a cold query ~3x faster than one worker but
        # score a warm one 1.6-1.9x slower (PERF.md §5).
        workers = max_workers or min(n, max(1, (os.cpu_count() or 2) // 2))
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="shard-router")
        self.failovers = 0
        self.last_stats = ClusterStats([None] * n)
        self._ingest_knobs: Optional[dict] = None
        self._part_cache: Optional[Tuple[int, object]] = None
        self._gen = store.generation

    # -- generation reconcile ------------------------------------------
    def _reconcile_generation(self):
        """An in-process ``ShardedStore.rebalance`` leaves every cached
        session pointing at directories the rebalance just deleted (and
        possibly the wrong shard count). Entry points call this first:
        when the manifest generation has moved, cached sessions are
        closed and the session/health arrays resized to the live
        topology, so searches and appends address the new generation.
        Not safe concurrently *with* the rebalance itself — quiesce
        traffic (and ``flush_ingest``) before rebalancing, as documented
        there."""
        if self._gen == self.store.generation:
            return
        stale: List[FlashSearchSession] = []
        with self._lock:
            # only the array swap happens under the lock — closing a
            # session can block on its compactor join, and concurrent
            # queries must not stall behind that
            if self._gen != self.store.generation:
                stale = [s for row in self._sessions for s in row
                         if s is not None]
                n, r = self.store.n_shards, self.store.replicas
                self._sessions = [[None] * r for _ in range(n)]
                self._down = [[False] * r for _ in range(n)]
                self._sess_locks = [[threading.Lock() for _ in range(r)]
                                    for _ in range(n)]
                self.last_stats = ClusterStats([None] * n)
                self._gen = self.store.generation
        for sess in stale:
            sess.close()
        if stale:
            log.info("router(%s): generation %d live; %d stale session(s) "
                     "closed", self.store.root, self._gen, len(stale))

    # -- replica health ------------------------------------------------
    def _session(self, shard: int, replica: int) -> FlashSearchSession:
        with self._lock:
            if self._sessions[shard][replica] is None:
                sess = FlashSearchSession(
                    self.store.store(shard, replica), self.cfg,
                    self.device, backend=self.backend,
                    use_filter=self.use_filter,
                    prefetch_depth=self.prefetch_depth,
                    slab_cache=self.slab_cache,
                    cache_bytes=None if self.slab_cache is not None else 0,
                    obs=self.obs, mode=self.mode,
                    candidates=self.candidates,
                    approx_min_docs=(self.approx_min_docs
                                     if self.approx_min_docs is not None
                                     else DEFAULT_APPROX_MIN_DOCS),
                    memo=self._memo)
                if self._ingest_knobs is not None:
                    sess.enable_ingest(**self._ingest_knobs)
                self._sessions[shard][replica] = sess
            return self._sessions[shard][replica]

    # -- live ingestion (DESIGN.md §6.3) -------------------------------
    def enable_ingest(self, **knobs):
        """Arm every shard session (existing and future) with a write
        path; each replica directory gets its own WAL + memtable +
        compactor, keeping replicas byte-wise independent."""
        with self._lock:
            self._ingest_knobs = knobs
            open_sessions = [s for row in self._sessions for s in row
                             if s is not None]
        for sess in open_sessions:
            sess.enable_ingest(**knobs)

    def _partitioner(self):
        """The live partitioner, re-read when the manifest generation
        moves — so appends issued after an in-process ``rebalance`` land
        on the *new* generation's owner shard."""
        gen = self.store.generation
        if self._part_cache is None or self._part_cache[0] != gen:
            self._part_cache = (gen, self.store.partitioner)
        return self._part_cache[1]

    def append(self, doc_id: int, pairs) -> int:
        """Route one document to its owner shard (pure function of the
        doc id, same policy the build used) and append it to every
        *in-rotation* replica, keeping those content-identical.

        A replica whose append fails while a sibling's succeeded is now
        content-divergent, so it is health-marked down — out of both
        read and write rotation until ``reset_health`` (which, as with
        read failover, is only correct after the replica directory has
        been repaired or rebuilt; §14). If every replica fails the error
        travels with the document and nothing is marked, mirroring the
        read path's poisoned-query rule. Returns the owner shard."""
        if self._ingest_knobs is None:
            raise RuntimeError(
                "append() needs enable_ingest() first — the cluster is "
                "read-only until a write path is attached")
        self._reconcile_generation()
        shard = int(self._partitioner().shard_of(
            np.asarray([doc_id], np.int64))[0])
        failed: List[Tuple[int, Exception]] = []
        wrote = 0
        for rep in range(self.store.replicas):
            if self._down[shard][rep]:
                continue
            try:
                self._session(shard, rep).append(doc_id, pairs)
                wrote += 1
            except Exception as e:
                log.warning("shard %d replica %d append failed (%s)",
                            shard, rep, e)
                failed.append((rep, e))
        if failed:
            if wrote:        # divergence: the failed copies are stale
                for rep, _ in failed:
                    self.mark_down(shard, rep)
            raise failed[0][1]
        if not wrote:
            raise ClusterSearchError(
                f"shard {shard}: no replica in rotation to append to")
        return shard

    def flush_ingest(self) -> int:
        """Seal every open shard session's memtable (call before a
        rebalance: rebalance streams segments, not WAL tails)."""
        return sum(s.flush_ingest() for s in self._open_sessions())

    def ingest_pipelines(self) -> List:
        """The live IngestPipelines of every opened replica session
        (introspection: the launcher aggregates their seal/fold stats)."""
        return [s.ingest for s in self._open_sessions()
                if s.ingest is not None]

    def _open_sessions(self) -> List[FlashSearchSession]:
        with self._lock:
            return [s for row in self._sessions for s in row
                    if s is not None]

    def mark_down(self, shard: int, replica: int):
        """Health-mark a replica out of rotation (also called by the
        failover path). A downed replica is never retried until
        ``reset_health``."""
        with self._lock:
            if not self._down[shard][replica]:
                self._down[shard][replica] = True
                self.failovers += 1

    def reset_health(self):
        with self._lock:
            for row in self._down:
                row[:] = [False] * len(row)

    def health(self) -> List[List[bool]]:
        """``health()[s][r]`` — True while the replica is in rotation."""
        with self._lock:
            return [[not d for d in row] for row in self._down]

    # -- scatter/gather ------------------------------------------------
    def _hedge_executor(self) -> SpawnExecutor:
        with self._lock:
            if self._hedge_pool is None:
                self._hedge_pool = SpawnExecutor()
            return self._hedge_pool

    def _attempt(self, shard: int, rep: int, query: Query, span,
                 scoring_opts: Optional[QueryOptions] = None
                 ) -> Tuple[SearchResult, SearchStats, int]:
        """One replica attempt, serialized per (shard, replica): the
        session is stateful, so a losing hedge or an abandoned straggler
        still scoring must finish before the next query's attempt on
        the same replica starts. The stats snapshot is taken under the
        same lock, so it can't pair with a later query's counters.

        ``scoring_opts`` carries only the scoring-tier knobs (mode /
        recall_target / candidates, never k or deadlines — those belong
        to the gather); it is None unless the caller set one of them,
        so the legacy flow through the shard session is untouched."""
        rspan = span.child("replica", replica=rep)
        try:
            with self._sess_locks[shard][rep]:
                sess = self._session(shard, rep)
                # dispatch via .search (typed form: no shim, no warning)
                # so fault-injecting wrappers that intercept .search see
                # every replica attempt
                res = sess.search(query, options=scoring_opts,
                                  _span=rspan)
                if scoring_opts is not None:
                    res = res.results   # unwrap the SearchResponse
                st = dataclasses.replace(sess.last_stats)
        except BaseException as e:
            rspan.end(error=repr(e))
            raise
        rspan.end()
        return res, st, rep

    def _search_shard(self, shard: int, query: Query, span=NULL_SPAN,
                      hedge_after_s: Optional[float] = None,
                      trace_id: Optional[int] = None,
                      scoring_opts: Optional[QueryOptions] = None
                      ) -> Tuple[SearchResult, SearchStats, float, int, int]:
        """Pool-thread body: primary replica first, then the next in
        replica order — *sequentially* on failure (the fail-over path),
        and additionally *concurrently* after ``hedge_after_s`` of
        silence when hedging is armed (the straggler path; replicas are
        byte-identical, so first-result-wins is still bit-identical). A
        failed attempt contributes nothing to the merge (its candidates
        are discarded whole), so retried shards can never duplicate
        documents.

        A replica is health-marked down only when a *sibling* replica
        then succeeds on the same query — that localizes the fault to
        the replica. A hedge that merely *outruns* a slow primary marks
        nothing: slow is not failed. When every replica fails, the
        error almost certainly travels with the query (bad shape,
        poisoned input), so no marks are recorded and the next query
        gets every replica back: one malformed request must never brick
        the cluster — the raised ``ClusterSearchError`` carries the
        shard id, per-replica error summaries, and the trace id.

        ``span`` is this shard's child of the cluster trace; each
        replica attempt nests one level deeper, so fail-overs and
        hedges show up as sibling replica spans (failed ones attr'd
        with their error). Returns (result, stats, wall_ms,
        hedges_fired, hedge_won)."""
        t0 = time.perf_counter()
        reps = [r for r in range(self.store.replicas)
                if not self._down[shard][r]]
        try:
            if not reps:
                raise ClusterSearchError(
                    f"shard {shard}: no replica in rotation",
                    shard=shard, trace_id=trace_id)
            errs: Dict[int, BaseException] = {}
            fired = won = 0
            if hedge_after_s is not None and len(reps) > 1:
                def make(rep: int):
                    def attempt():
                        try:
                            return self._attempt(shard, rep, query, span,
                                                 scoring_opts)
                        except BaseException as e:
                            errs[rep] = e
                            raise
                    return attempt

                try:
                    out = run_hedged(
                        [make(r) for r in reps], self._hedge_executor(),
                        hedge_after_s=hedge_after_s,
                        on_hedge=lambda i: log.debug(
                            "shard %d: hedging to replica %d", shard,
                            reps[i]))
                except ClusterSearchError:
                    raise
                except BaseException as e:
                    raise ClusterSearchError(
                        f"shard {shard}: all {len(reps)} in-rotation "
                        f"replicas failed",
                        shard=shard, trace_id=trace_id,
                        replica_errors={r: repr(x)
                                        for r, x in errs.items()}) from e
                res, st, rep = out.result
                fired, won = out.hedges_fired, int(out.hedge_won)
            else:
                res = None
                for rep in reps:
                    try:
                        res, st, _ = self._attempt(shard, rep, query, span,
                                                   scoring_opts)
                        break
                    except Exception as e:
                        errs[rep] = e
                        log.warning(
                            "shard %d replica %d failed (%s); failing over",
                            shard, rep, e)
                if res is None:
                    raise ClusterSearchError(
                        f"shard {shard}: all {len(reps)} in-rotation "
                        f"replicas failed",
                        shard=shard, trace_id=trace_id,
                        replica_errors={r: repr(x) for r, x in errs.items()}
                    ) from (errs[reps[-1]] if reps[-1] in errs else None)
            # the winner proves the query is serveable: errored siblings
            # (fail-overs in either path) leave rotation
            for r in errs:
                if r != rep:
                    self.mark_down(shard, r)
            wall_ms = (time.perf_counter() - t0) * 1e3
            span.end(replica=rep, wall_ms=round(wall_ms, 3),
                     **({"hedges": fired} if fired else {}))
            return res, st, wall_ms, fired, won
        except BaseException as e:
            span.end(error=repr(e))
            raise

    def search_typed(self, query: Query,
                     options: Optional[QueryOptions] = None, *,
                     _span=None) -> SearchResult:
        """Typed scatter/gather: ``Query`` rows ``[L, Qn]`` (pad < 0) ->
        global ``[L, k]`` top-k over every shard. Shards run
        concurrently; the merge folds in shard order, so results are
        deterministic regardless of which shard finishes first.

        ``options`` is the scheduling contract (DESIGN.md §7.3):
        ``deadline_ms`` + ``allow_partial=True`` cap the gather wait —
        shards that haven't answered at the budget are dropped from the
        merge and listed in ``last_stats.shards_missing`` (and a failed
        shard becomes a missing shard instead of an error);
        ``hedging`` overrides the router's straggler policy. Per-query
        ``k`` truncation and ``SearchResponse`` wrapping belong to the
        public ``search`` shim — this method always returns the raw
        merged ``SearchResult`` (what the coalescing service demuxes)."""
        self._reconcile_generation()
        opts = options if options is not None else QueryOptions()
        q_rows = query.rows()
        t_start = time.perf_counter()
        deadline = (t_start + opts.deadline_ms / 1e3
                    if opts.deadline_ms is not None else None)
        n = self.store.n_shards
        trace = self.obs.tracer.start("query", surface="cluster",
                                      L=int(q_rows[0].shape[0]), shards=n)
        root = trace.root if trace is not None else NULL_SPAN
        trace_id = trace.trace_id if trace is not None else None
        reg = self.obs.registry
        h_shard = reg.histogram("cluster_shard_ms")
        # resolve the straggler policy: per-query override beats the
        # router default; hedging needs a second replica to fire at
        policy = self.hedge_policy
        if opts.hedging is False:
            policy = None
        elif opts.hedging is True and policy is None:
            policy = HedgePolicy()
        hedge_after_s = (policy.hedge_after_ms(reg) / 1e3
                         if policy is not None and self.store.replicas > 1
                         else None)
        # scoring-tier knobs travel to every shard session; None when
        # the caller set none of them, so the default flow is untouched
        scoring_opts = None
        if (opts.mode is not None or opts.recall_target is not None
                or opts.candidates is not None):
            scoring_opts = QueryOptions(mode=opts.mode,
                                        recall_target=opts.recall_target,
                                        candidates=opts.candidates)
        stats = ClusterStats([None] * n)
        walls: List[Optional[float]] = [None] * n
        missing: List[int] = []
        try:
            shard_spans = [root.child("shard", shard=s) for s in range(n)]
            futs = [self._pool.submit(self._search_shard, s, query,
                                      shard_spans[s], hedge_after_s,
                                      trace_id, scoring_opts)
                    for s in range(n)]
            # the gather span covers waiting out the stragglers plus the
            # shard-order fold — the scatter itself lives in the shard
            # children above
            gspan = root.child("gather")
            partial_ok = opts.allow_partial and deadline is not None
            if partial_ok:
                # one bounded wait for the whole scatter; anything not
                # done at the budget is abandoned (it keeps running on
                # the pool — the per-replica locks serialize it against
                # the next query — but contributes nothing here)
                wait(futs, timeout=max(0.0, deadline - time.perf_counter()))
            best: Optional[SearchResult] = None
            err: Optional[BaseException] = None
            for s, fut in enumerate(futs):
                if partial_ok and not fut.done():
                    missing.append(s)
                    shard_spans[s].end(abandoned=True)
                    continue
                try:
                    # without partial consent this blocks for the shard:
                    # the legacy full-gather contract
                    res, st, wall_ms, fired, won = fut.result()
                except BaseException as e:
                    if opts.allow_partial:
                        # degraded, not failed: SpANNS-style flagged
                        # partial answer — the caller consented
                        missing.append(s)
                        continue
                    err = err or e
                    continue
                stats.hedges += fired
                stats.hedge_wins += won
                walls[s] = wall_ms
                h_shard.observe(wall_ms)
                # per-shard series feed the per-shard latency SLOs
                # (§8.4) and make a straggling shard visible in /metrics
                # without joining against the trace attrs
                reg.histogram("cluster_shard_ms", shard=str(s)).observe(
                    wall_ms)
                stats.per_shard[s] = st
                best = res if best is None else _merge_results(
                    best, res, self.cfg.top_k)
            done = [s for s, w in enumerate(walls) if w is not None]
            if done:
                straggler = max(done, key=lambda s: walls[s])
                reg.histogram("cluster_straggler_ms").observe(
                    walls[straggler])
                root.set(straggler_shard=straggler,
                         straggler_ms=round(walls[straggler], 3))
            gspan.end(shards_merged=len(done),
                      **({"shards_missing": missing} if missing else {}))
        finally:
            if trace is not None:
                trace.finish()
        stats.failovers = self.failovers
        stats.partial = bool(missing)
        stats.shards_missing = tuple(missing)
        if missing:
            reg.counter("cluster_partial_total").inc()
            log.warning("cluster gather partial: shards %s missed the "
                        "%.1fms budget", missing, opts.deadline_ms or 0.0)
        if stats.hedges:
            reg.counter("cluster_hedges_total").inc(stats.hedges)
        if stats.hedge_wins:
            reg.counter("cluster_hedge_wins_total").inc(stats.hedge_wins)
        self.last_stats = stats
        if err is not None:
            # the cluster availability-SLO bad-event stream (§8.4);
            # queries_total for the surface counts in publish_search_stats
            reg.counter("query_errors_total", surface="cluster").inc()
            reg.counter("queries_total", surface="cluster").inc()
            raise err
        if best is None:
            # every shard missed the budget: a well-formed no-result
            # answer ([L, k] sentinel rows), flagged partial above —
            # never a hang, never a malformed shape
            L, k = q_rows[0].shape[0], self.cfg.top_k
            best = SearchResult(np.full((L, k), -1, np.int64),
                                np.full((L, k), -np.inf, np.float32))
        self.obs.note_query(
            "cluster", (time.perf_counter() - t_start) * 1e3,
            shards=n, segments_scored=stats.segments_scored,
            cache_hits=stats.cache_hits)
        self.obs.publish_search_stats(stats, surface="cluster")
        return best

    def search(self, query, q_vals=None, *,
               options: Optional[QueryOptions] = None):
        """Public search surface. Typed form — ``search(Query(ids,
        vals), options=QueryOptions(...))`` — returns a
        ``SearchResponse`` carrying this query's scheduling stats;
        positional ``search(q_ids, q_vals)`` arrays remain as a
        deprecation shim returning the bare ``SearchResult``
        (``serve/api.py``)."""
        try:
            q, options = coerce_request(query, q_vals, options,
                                        surface="ShardRouter.search")
        except ValueError as e:
            # a malformed query is still a ClusterSearchError at this
            # surface (the pre-redesign contract): it fails before any
            # shard work, so replica health is never marked
            raise ClusterSearchError(f"malformed query: {e}") from e
        res = self.search_typed(q, options=options)
        if options is None:
            return res
        st = self.last_stats
        return SearchResponse(truncate_k(res, options.k), QueryStats(
            partial=st.partial, hedged=bool(st.hedge_wins),
            shards_missing=st.shards_missing,
            deadline_ms=options.deadline_ms, tenant=options.tenant))

    # -- introspection -------------------------------------------------
    @property
    def last_trace(self):
        """Most recent sampled cluster QueryTrace (None unless the
        shared ``obs`` samples traces)."""
        return self.obs.tracer.last_trace

    @property
    def cache_stats(self) -> Optional[CacheStats]:
        """Locked snapshot of the cluster-shared slab cache's lifetime
        counters, or None when the cache is disabled. Shard sessions
        mutate the counters concurrently under the cache lock, so the
        lock-free live object could pair mid-flight hits/misses."""
        return (self.slab_cache.stats_snapshot()
                if self.slab_cache is not None else None)

    @property
    def memo_stats(self):
        """Lifetime counters of the cluster-shared recurrent-query memo
        cache (None when the memo is off)."""
        return (self._memo.stats_snapshot()
                if self._memo is not None else None)

    def compile_counts(self) -> List[List[int]]:
        """Engine traces per *opened* (shard, replica) session — the
        per-shard L-bucket bound (DESIGN.md §7.2) applies to each."""
        with self._lock:
            return [[s.engine.compile_stats["n_traces"]
                     for s in row if s is not None]
                    for row in self._sessions]

    def close(self):
        self._pool.shutdown(wait=True)
        with self._lock:
            hedge_pool, self._hedge_pool = self._hedge_pool, None
        if hedge_pool is not None:
            hedge_pool.shutdown(wait=True)
        with self._lock:
            for row in self._sessions:
                for sess in row:
                    if sess is not None:
                        sess.close()
            self._sessions = [[None] * self.store.replicas
                              for _ in range(self.store.n_shards)]
        self.store.close()
