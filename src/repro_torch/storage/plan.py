"""Query planning and the shared plan executor (DESIGN.md §4.1).

Every scoring surface — single store, live memtable snapshot, sharded
cluster, micro-batched service — used to hand-roll the same implicit
scan: walk the manifest, filter, read + decode each survivor from
disk. This module makes that plan *explicit* and single-sourced:

    Planner.plan(view, q_ids[, snap])  ->  QueryPlan
    execute_plan(engine, view, plan, q_ids, q_vals, ...) -> SearchResult

A ``view`` duck-types the segment surface (``entries`` / ``segment`` /
``release`` / ``cache_token`` — a FlashStore or an ingest Snapshot).
The plan records one verdict per manifest segment (skip via the §3.2
vocabulary filter, or scan), the slab source for each survivor
(``cache``: already decoded + device-resident in the §4.2 SlabCache;
``disk``: mmap read -> decode -> upload to the card), the memtable tail
when the view is a live snapshot, and the padded launch shape. Steps
are ordered cache-first so the prefetcher thread overlaps every disk
decode behind the free cache hits.

The executor is the only scan loop in the tree: it streams the plan's
steps through the §3.3 Prefetcher, scores each slab as it lands, and
folds the per-slab candidates in *manifest rank order* (memtable last)
so the scan-order optimization can never change score-tie breaking
relative to a cold scan. The cache is consulted at *execution* time (a
planned hit that was evicted in between simply degrades to a disk load
— plans are advisory about sources, never about correctness), and one
``SearchStats`` is filled, including the cache hit/miss/eviction
counters.

The port of ``repro.storage.plan``. The loader runs in the prefetch
thread and uploads there, on the engine's card and on that thread's
current stream, which is the card's default stream as for the scoring
thread: the copies are synchronous from pageable host memory and ordered
before the scoring launches, so no event or ``record_stream`` is needed.
A fused slab's ``decode`` time holds its tiling and upload (its
``upload`` is 0), as in the reference. A live snapshot's memtable is
padded to the segment launch shape on the host and uploaded by the
scoring thread with every query (``search_streaming`` of its
``Corpus``), as in the reference.

On a mesh the slab pad aligns to the mesh rows (``rows``), and a
``lockstep`` planner scans in manifest order: each rank's slab cache is
its own, and a cache-first order that differed between ranks would have
them reduce candidates of different slabs together. For the same reason
the approximate tier, which scores a cached segment's whole slab and any
other its candidate pool, takes the leader's cache verdict on every rank
(``cached_names``, then ``plan(verdict=...)``): a rank scores what the
leader's cache held, whatever its own holds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import stream_format
from repro_torch.core.corpus import Corpus
from repro_torch.core.engine import _merge_results, _next_pow2
from repro_torch.obs import NULL_REGISTRY, NULL_SPAN
from repro_torch.storage import filter as filter_lib
from repro_torch.storage import postings as postings_lib
from repro_torch.storage.prefetch import Prefetcher
from repro_torch.storage.slabcache import SlabCache, slab_key

SOURCE_CACHE = "cache"
SOURCE_DISK = "disk"

MODE_EXACT = "exact"
MODE_APPROX = "approx"
MODE_AUTO = "auto"
MODES = (MODE_EXACT, MODE_APPROX, MODE_AUTO)
# "auto" takes the approximate tier only past this many snapshot docs:
# below it the exhaustive scan is already a handful of slabs and the
# posting traversal would cost more than it saves
DEFAULT_APPROX_MIN_DOCS = 4096


@dataclasses.dataclass(frozen=True)
class PlanStep:
    """One surviving segment in scan order. ``rank`` is its position in
    *manifest* order among the scored segments — the executor folds
    results by rank, so the cache-first scan order can never change the
    merge's tie-breaking relative to a cold manifest-order scan."""
    name: str
    n_docs: int
    source: str            # SOURCE_CACHE | SOURCE_DISK (advisory)
    rank: int              # manifest-order fold position


@dataclasses.dataclass
class QueryPlan:
    """Explicit per-query scan plan over one snapshot view."""
    steps: List[PlanStep]              # cache-first scan order
    skipped: List[str]                 # filter-pruned segment names
    segments_total: int
    slab_docs: int                     # padded launch shape (§3.3)
    nnz_pad: int
    cache_token: object                # store identity for cache keys
    generation: int = 0                # generation the view's segment
                                       # list belongs to (capture-time
                                       # for snapshots): admission is
                                       # skipped once the live one
                                       # moves (see execute_plan)
    memtable: Optional[Corpus] = None  # live tail (unpadded), or None
    memtable_trunc: int = 0
    memtable_pad: int = 0              # doubling pad target for the tail
    fmt: str = "ell"                   # engine slab layout (§12.2):
                                       # "ell", "packed" or
                                       # "fused:<block_docs>"
    mode: str = MODE_EXACT             # resolved per query: exact scans
                                       # every surviving slab; approx
                                       # takes the posting-candidate +
                                       # re-rank path per disk segment
    candidates: int = 0                # top-C pool size per segment row
                                       # (approx mode only)
    filtered: bool = False             # vocab-filter pruning ran — the
                                       # executor may attribute zero-
                                       # score survivors to filter FPs
    pinned: bool = False               # approx sources are a lockstep
                                       # verdict: a cache step scores
                                       # its whole slab, a disk step its
                                       # candidate pool, whatever this
                                       # rank's cache holds

    def key_for(self, name: str):
        return slab_key(self.cache_token, name, self.nnz_pad,
                        self.slab_docs, self.fmt)

    @property
    def n_cached(self) -> int:
        return sum(s.source == SOURCE_CACHE for s in self.steps)

    @property
    def n_disk(self) -> int:
        return sum(s.source == SOURCE_DISK for s in self.steps)

    @property
    def is_empty(self) -> bool:
        return not self.steps and self.memtable is None


class Planner:
    """Turns (snapshot view, query batch) into a QueryPlan. Stateless
    beyond its knobs, so one instance serves every query of a session."""

    def __init__(self, *, nnz_pad: int, rows: int, use_filter: bool = True,
                 cache: Optional[SlabCache] = None, fmt: str = "ell",
                 mode: str = MODE_EXACT, candidates: int = 0,
                 approx_min_docs: int = DEFAULT_APPROX_MIN_DOCS,
                 lockstep: bool = False):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.nnz_pad = nnz_pad
        self.rows = rows                # rows the slab pad aligns to
                                        # (1 on one card)
        self.lockstep = lockstep        # manifest scan order (a mesh)
        self.use_filter = use_filter
        self.cache = cache
        self.fmt = fmt                  # the engine's slab_fmt: cache
                                        # verdicts must probe the same
                                        # keys the executor will load
        self.mode = mode                # session default; plan() takes a
                                        # per-query override
        self.candidates = candidates    # default top-C pool per segment
        self.approx_min_docs = approx_min_docs

    def slab_docs(self, view) -> int:
        """The view's one launch shape: its largest segment, padded to a
        multiple of the mesh rows."""
        return -(-max(view.max_segment_docs, 1) // self.rows) * self.rows

    def resolve_mode(self, view, mode: Optional[str] = None) -> str:
        """The query's tier: ``mode`` (None = the session default), with
        ``auto`` resolved against the view's total doc count."""
        eff_mode = self.mode if mode is None else mode
        if eff_mode not in MODES:
            raise ValueError(
                f"mode must be one of {MODES}, got {eff_mode!r}")
        if eff_mode == MODE_AUTO:
            total_docs = sum(e.n_docs for e in view.entries)
            eff_mode = (MODE_APPROX if total_docs >= self.approx_min_docs
                        else MODE_EXACT)
        return eff_mode

    def cached_names(self, view) -> List[str]:
        """The view's segments whose slab this rank's cache holds now:
        the leader's verdict for a lockstep batch (``plan``'s
        ``verdict``)."""
        if self.cache is None:
            return []
        slab_docs, token = self.slab_docs(view), view.cache_token
        return [e.name for e in view.entries if self.cache.peek(
            slab_key(token, e.name, self.nnz_pad, slab_docs, self.fmt))]

    def plan(self, view, q_ids: np.ndarray, snap=None, *,
             mode: Optional[str] = None,
             candidates: Optional[int] = None,
             verdict: Optional[Sequence[str]] = None) -> QueryPlan:
        """``snap`` carries the memtable when ``view`` is a live
        Snapshot (the session passes the same object twice). ``mode`` /
        ``candidates`` override the session defaults for this query
        (the QueryOptions knobs); ``auto`` resolves against the view's
        total doc count here, where the manifest is already in hand.
        ``verdict`` (a lockstep batch's, the leader's ``cached_names``)
        replaces this rank's cache probe as each step's source, and
        binds the approximate tier to it."""
        entries = view.entries
        slab_docs = self.slab_docs(view)
        token = view.cache_token
        eff_mode = self.resolve_mode(view, mode)
        eff_cand = self.candidates if candidates is None else int(candidates)
        held = None if verdict is None else frozenset(verdict)
        if eff_mode == MODE_APPROX and eff_cand <= 0:
            raise ValueError("approx mode needs a positive candidate "
                             "pool size (candidates)")
        # the query's probe state (dedup + splitmix64 mixes) is computed
        # ONCE here and reused for every segment verdict below — the
        # per-segment cost is a bitmap gather or a Bloom modulo only
        probe = filter_lib.QueryProbe(q_ids) if self.use_filter else None
        do_filter = probe is not None and probe.ids.size > 0
        cached: List[PlanStep] = []
        disk: List[PlanStep] = []
        skipped: List[str] = []
        # one segment handle held at a time: a skipped segment costs its
        # footer + filter pages, a survivor is reopened lazily by the
        # executor's loader (snapshot entries stay openable — the
        # pipeline defers GC while the snapshot lives)
        rank = 0
        for entry in entries:
            if do_filter:
                seg = view.segment(entry.name)
                hit_any = seg.vocab_filter.contains_any_probe(probe)
                view.release(entry.name)
                if not hit_any:
                    skipped.append(entry.name)
                    continue
            key = slab_key(token, entry.name, self.nnz_pad, slab_docs,
                           self.fmt)
            hit = (entry.name in held if held is not None
                   else self.cache is not None and self.cache.peek(key))
            step = PlanStep(entry.name, entry.n_docs,
                            SOURCE_CACHE if hit else SOURCE_DISK, rank)
            rank += 1
            (cached if step.source == SOURCE_CACHE else disk).append(step)
        mem_corpus, mem_trunc = (snap.memtable_corpus(self.nnz_pad)
                                 if snap is not None else (None, 0))
        mem_pad = 0
        if mem_corpus is not None:
            # reuse the segment launch shape whenever the memtable fits;
            # a memtable that outgrows it pads to the next *doubling* so
            # interleaved append/search launches O(log) shapes (§3.4)
            mem_pad = slab_docs
            while mem_pad < mem_corpus.n_docs:
                mem_pad *= 2
        steps = cached + disk
        if self.lockstep:
            steps.sort(key=lambda st: st.rank)
        return QueryPlan(steps=steps, skipped=skipped,
                         segments_total=len(entries), slab_docs=slab_docs,
                         nnz_pad=self.nnz_pad, cache_token=token,
                         generation=view.generation,
                         memtable=mem_corpus, memtable_trunc=mem_trunc,
                         memtable_pad=mem_pad, fmt=self.fmt,
                         mode=eff_mode, candidates=eff_cand,
                         filtered=do_filter,
                         pinned=(held is not None
                                 and eff_mode == MODE_APPROX))


def execute_plan(engine, view, plan: QueryPlan, q_ids: np.ndarray,
                 q_vals: np.ndarray, *, stats,
                 cache: Optional[SlabCache] = None,
                 prefetch_depth: int = 2, span=NULL_SPAN,
                 registry=None):
    """Run one QueryPlan: prefetch + score its slab stream, mutating
    ``stats`` (a SearchStats) as slabs resolve. The shared scan loop
    behind every scoring surface (DESIGN.md §4.1).

    Slabs are *scored* in the plan's cache-first scan order (so the
    prefetcher overlaps disk decodes behind the free hits) but their
    per-slab candidates are *folded* in manifest rank order, memtable
    last — exactly the cold scan's fold. ``_merge_results`` breaks
    score ties by fold position, so without the rank fold a partially
    warm query could flip tied candidates relative to a cold one.

    ``span``/``registry`` are the §8 observability hooks: per-segment
    child spans (slab source, decode/upload ms) hang off ``span`` when
    a trace sampled this query (``NULL_SPAN`` otherwise — allocation-
    free), and stage latencies land in the registry's ``stage_ms``
    histograms. Neither touches the numeric path: scan order, fold
    order, and every array op are identical with observability on,
    off, or disabled."""
    reg = NULL_REGISTRY if registry is None else registry
    h_decode = reg.histogram("stage_ms", stage="decode")
    h_upload = reg.histogram("stage_ms", stage="upload")
    h_score = reg.histogram("stage_ms", stage="score")
    # the Obs.disabled() floor (§8.1): with a null registry AND no trace
    # span, every perf_counter() read below is dead weight — skip them
    # all, so the disabled path costs zero clock syscalls per slab
    timed = not (reg is NULL_REGISTRY and span is NULL_SPAN)

    def load(step: PlanStep):
        """Prefetch-thread body: cache lookup, else mmap read -> ELL
        decode -> device upload (+ admission). At most ``prefetch_depth``
        segments are open during the scoring stream."""
        lspan = span.child("load", segment=step.name, rank=step.rank)
        # the approximate tier scores a cache hit's whole slab; under a
        # lockstep verdict the step's source, not this rank's cache,
        # decides which (a missing verdict hit loads the slab from disk)
        approx = plan.mode == MODE_APPROX and not (
            plan.pinned and step.source == SOURCE_CACHE)
        if cache is not None and not (plan.pinned and approx):
            hit = cache.get(plan.key_for(step.name))
            if hit is not None:
                stats.cache_hits += 1
                stats.docs_scored += hit.n_docs
                stats.pairs_truncated += hit.n_trunc
                lspan.end(source=SOURCE_CACHE)
                return step, hit.slab
            stats.cache_misses += 1
        t0 = time.perf_counter() if timed else 0.0
        seg = view.segment(step.name)
        if approx and seg.postings is not None:
            # approximate tier (§15): posting traversal picks the top-C
            # candidate pool, then ONLY those rows are decoded (page-
            # level partial decode) and re-ranked exactly through the
            # session backend. The mini-slab is keyed by the query, so
            # it is never admitted to the slab cache; a pre-postings
            # segment file (postings is None) falls through to the
            # exhaustive branch below.
            pool = seg.postings.candidates(q_ids, q_vals, plan.candidates)
            doc_ids, ids, vals, norms, n_trunc = postings_lib.gather_rows(
                seg, pool, plan.nnz_pad)
            view.release(step.name)
            t1 = time.perf_counter() if timed else 0.0
            n_docs = int(doc_ids.size)
            stats.docs_scored += n_docs
            stats.pairs_truncated += n_trunc
            stats.approx_segments += 1
            stats.candidates += n_docs
            if n_docs == 0:
                lspan.end(source=SOURCE_DISK, approx=True, candidates=0)
                return step, None
            # pow2 pad capped at the plan shape: candidate pools of any
            # size launch O(log slab_docs) distinct shapes
            corpus = Corpus(doc_ids, ids, vals, norms).pad_docs_to(
                min(plan.slab_docs, _next_pow2(n_docs)))
            slab = engine.put_slab(corpus)
            t2 = time.perf_counter() if timed else 0.0
            if timed:
                h_decode.observe((t1 - t0) * 1e3)
                h_upload.observe((t2 - t1) * 1e3)
                lspan.end(source=SOURCE_DISK, approx=True,
                          candidates=n_docs,
                          decode_ms=round((t1 - t0) * 1e3, 3),
                          upload_ms=round((t2 - t1) * 1e3, 3))
            return step, slab
        if plan.fmt.startswith("fused"):
            # the fused kernel decodes the Fig. 8 words on-device: the
            # segment stream is only *tiled* here (a boundary-index
            # pass), never staged through host ELL arrays (§12.2). The
            # mmap view stays open until the tiles are built — tiling
            # copies, so the segment can be released right after.
            slab, n_docs, n_trunc = engine.put_stream_slab(
                seg.stream(), pad_docs_to=plan.slab_docs)
            view.release(step.name)
            t1 = t2 = time.perf_counter() if timed else 0.0
            stats.docs_scored += n_docs
            stats.pairs_truncated += n_trunc
        else:
            doc_ids, ids, vals, norms, n_trunc = stream_format.decode_to_ell(
                seg.stream(), plan.nnz_pad)
            view.release(step.name)
            t1 = time.perf_counter() if timed else 0.0
            n_docs = int(doc_ids.size)
            stats.docs_scored += n_docs
            stats.pairs_truncated += n_trunc
            corpus = Corpus(doc_ids, ids, vals, norms)
            slab = engine.put_slab(corpus.pad_docs_to(plan.slab_docs))
            t2 = time.perf_counter() if timed else 0.0
        if timed:
            h_decode.observe((t1 - t0) * 1e3)
            h_upload.observe((t2 - t1) * 1e3)
        # admission is gated on the LIVE store generation still matching
        # the generation the plan's segment list was captured at: once a
        # fold/compact has moved it, this segment may be a graveyard
        # file a snapshot is straggling over — admitting it would undo
        # the precise invalidation and squat in the budget. The guard
        # runs under the cache lock (see SlabCache.put) so it cannot
        # race the fold's invalidate.
        if cache is not None:
            stats.cache_evictions += cache.put(
                plan.key_for(step.name), slab,
                n_docs=n_docs, n_trunc=n_trunc,
                admit=lambda: view.live_generation == plan.generation)
        if timed:
            lspan.end(source=SOURCE_DISK,
                      decode_ms=round((t1 - t0) * 1e3, 3),
                      upload_ms=round((t2 - t1) * 1e3, 3))
        return step, slab

    if plan.is_empty:
        span.set(empty=True)
        return engine.empty_result(q_ids.shape[0])
    # one fold slot per scored segment in manifest order, + the memtable
    folds: List[Optional[object]] = [None] * (len(plan.steps) + 1)
    mem_slab = None
    if plan.memtable is not None:
        # stats land BEFORE the prefetcher (and its loader thread)
        # exists: += on shared counters from two threads would race
        stats.memtable_docs = plan.memtable.n_docs
        stats.docs_scored += plan.memtable.n_docs
        stats.pairs_truncated += plan.memtable_trunc
        mem_slab = plan.memtable.pad_docs_to(plan.memtable_pad)
    pf = Prefetcher(plan.steps, load, depth=prefetch_depth,
                    timed=timed) \
        if plan.steps else None
    try:
        if mem_slab is not None:
            # scored while the prefetcher's worker loads the first slabs
            sspan = span.child("score", segment="memtable")
            t0 = time.perf_counter() if timed else 0.0
            folds[-1] = engine.search_streaming(q_ids, q_vals, [mem_slab])
            if timed:
                h_score.observe((time.perf_counter() - t0) * 1e3)
            sspan.end(source="memtable", docs=stats.memtable_docs)
        if pf is not None:
            for step, slab in pf:
                if slab is None:        # empty approx candidate pool
                    continue
                sspan = span.child("score", segment=step.name,
                                   rank=step.rank)
                t0 = time.perf_counter() if timed else 0.0
                r = engine.search_streaming(q_ids, q_vals, [slab])
                folds[step.rank] = r
                # a segment the vocab filter let through whose every
                # real score is exactly 0 had no query-term overlap:
                # a filter false positive (exact for bitmaps, the
                # Bloom FPR made flesh) — surfaced per query so the
                # fleet can see when a filter has gone saturated
                if plan.filtered:
                    sc = np.asarray(r.scores)
                    fin = sc[np.isfinite(sc)]
                    if fin.size == 0 or not np.any(fin != 0):
                        stats.filter_fp_segments += 1
                if timed:
                    h_score.observe((time.perf_counter() - t0) * 1e3)
                sspan.end()
    finally:
        if pf is not None:
            pf.close()
    if pf is not None and timed:
        wait_ms = pf.consumer_wait_s * 1e3
        reg.histogram("stage_ms", stage="prefetch_wait").observe(wait_ms)
        span.set(prefetch_wait_ms=round(wait_ms, 3))
    mspan = span.child("merge")
    t0 = time.perf_counter() if timed else 0.0
    best = None
    for r in folds:
        if r is None:
            continue
        best = r if best is None else _merge_results(best, r,
                                                     engine.cfg.top_k)
    if timed:
        reg.histogram("stage_ms", stage="merge").observe(
            (time.perf_counter() - t0) * 1e3)
    mspan.end(folds=sum(r is not None for r in folds))
    return best
