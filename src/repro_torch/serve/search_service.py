"""SearchService — concurrent query serving with micro-batch coalescing
(DESIGN.md §7).

Many clients each hold one sparse query; the paper's engine wants one
L-column merged batch per corpus pass. The service bridges the two:

    client threads ── submit(Query, options=...) -> Future ──┐
                         (admission: quota + bounded queue)  ▼
                                           MicroBatcher (§7.1, §7.3)
                  flush on max_batch L, max_delay_ms, or EDF deadline
                                                             ▼
                            searcher.search([L, Qn] stacked batch)
                      (PatternSearchEngine or FlashSearchSession)
                                                             ▼
                              demux row l -> client l's Future

Results are bit-identical to calling ``searcher.search`` serially per
query: stacking pads rows with the -1 sentinel that the merge path
strips, scoring is column-independent, and the engine's L-bucketing
(core/engine.py) makes every coalesced shape hit a cached program. One
scheduler thread performs all scoring, so non-thread-safe searchers
(e.g. FlashSearchSession.last_stats) are safe behind ``submit``.

The scheduling layer (DESIGN.md §7.3): an optional
``AdmissionController`` sheds at the door with ``OverloadError``
before anything queues; ``QueryOptions.deadline_ms`` turns into an
absolute monotonic deadline the EDF batcher flushes early for and
drops past-due requests against (``DeadlineExceeded``); per-request
``QueryOptions`` demux into a ``SearchResponse`` with that request's
``QueryStats``. Submitting plain positional arrays (no options) keeps
the legacy contract bit-for-bit: FIFO keys, no admission, a bare
``SearchResult`` out.

A copy of ``repro.serve.search_service``: ``_score`` stacks one batch's
queries into one L-bucketed request, so a batch costs one pass over the
corpus or store on the card.

On a mesh of more than one rank (a searcher whose ``ctx`` spans several
processes) the service runs on rank 0 only, and leads: ``_score`` hands
the searcher the ``distributed.lockstep.Leader``, which broadcasts each
batch's record before it is scored, and ``close`` stops the followers.
Admission, the EDF batcher, deadline drops and the demux run before a
batch forms or after it is scored, on rank 0 alone. Every other rank
calls ``follow(searcher)`` (a session's ``follow()``), which scores the
leader's batches until that stop; a ``SearchService`` there raises
``RuntimeError``.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np

from repro_torch.core.engine import SearchResult
from repro_torch.distributed import lockstep
from repro_torch.serve.admission import AdmissionController
from repro_torch.serve.api import (Query, QueryOptions, QueryStats,
                                   SearchResponse, coerce_request,
                                   truncate_k)
from repro_torch.serve.batcher import BatcherStats, MicroBatcher


@dataclasses.dataclass
class _Request:
    q_ids: np.ndarray     # [Qn] int32, pad < 0
    q_vals: np.ndarray    # [Qn] float32
    future: Future
    options: Optional[QueryOptions] = None
    deadline: Optional[float] = None    # absolute time.monotonic instant
    priority: int = 0
    queue_wait_ms: float = 0.0          # written by the batcher at flush


def _batch_options(reqs: List["_Request"], now: float
                   ) -> Optional[QueryOptions]:
    """Fold the batch's per-request options into the one QueryOptions a
    typed searcher (cluster router) runs the whole batch under:

      deadline_ms    the *tightest* remaining budget — the batch is one
                     device pass, so it must fit the most urgent member
      allow_partial  only if every member consented (a partial merge
                     degrades all L rows at once)
      hedging        any False pins it off, else any True pins it on,
                     else None (router default) — an explicit opt-out
                     wins because hedging spends a replica's work

    None when no member carries options: the searcher sees the legacy
    positional call and the whole scheduling layer stays out of the
    data path."""
    opted = [r.options for r in reqs if r.options is not None]
    if not opted:
        return None
    deadline_ms = None
    live = [r.deadline for r in reqs if r.deadline is not None]
    if live:
        deadline_ms = max(0.0, (min(live) - now) * 1e3)
    allow_partial = bool(opted) and all(
        r.options is not None and r.options.allow_partial for r in reqs)
    hedge_votes = {o.hedging for o in opted if o.hedging is not None}
    hedging = (False if False in hedge_votes
               else True if True in hedge_votes else None)
    return QueryOptions(deadline_ms=deadline_ms, allow_partial=allow_partial,
                        hedging=hedging)


class SearchService:
    def __init__(self, searcher, *, max_batch: int = 8,
                 max_delay_ms: float = 2.0,
                 admission: Optional[AdmissionController] = None,
                 max_pending: Optional[int] = None,
                 tenant_qps: Optional[float] = None,
                 tenant_burst: Optional[float] = None):
        """``searcher`` is anything with ``.search(q_ids [L, Qn],
        q_vals [L, Qn]) -> SearchResult`` — the resident engine or a
        flash session (typed surfaces additionally exposing
        ``search_typed`` get the batch's folded QueryOptions).
        ``max_batch`` is the engine's L; keep it at the L-bucket
        granularity (a power of two times the model-axis size) so full
        batches need no pad columns.

        Admission control: pass a prebuilt ``admission`` controller, or
        the ``max_pending``/``tenant_qps``/``tenant_burst`` knobs to
        build one here; all-None means admit everything (legacy).

        A searcher on a mesh leads from rank 0 (the module docstring);
        on any other rank this raises ``RuntimeError``."""
        ctx = getattr(searcher, "ctx", None)
        role = lockstep.role(ctx)
        if role == lockstep.FOLLOWER:
            raise RuntimeError(
                "a SearchService on a follower rank: only rank 0 of a mesh "
                "serves; this rank scores its batches in follow()")
        self.searcher = searcher
        # share the searcher's observability bundle (every tier carries
        # one, DESIGN.md §8) so queue-wait/occupancy histograms land in
        # the same registry as the scoring stages
        self.obs = getattr(searcher, "obs", None)
        reg = self.obs.registry if self.obs is not None else None
        if admission is None and (max_pending is not None
                                  or tenant_qps is not None):
            admission = AdmissionController(
                max_pending=max_pending, tenant_qps=tenant_qps,
                tenant_burst=tenant_burst, registry=reg)
        self.admission = admission
        self._lockstep = (lockstep.Leader(ctx) if role == lockstep.LEADER
                          else None)
        self._batcher = MicroBatcher(
            self._run_batch, max_batch=max_batch, max_delay_ms=max_delay_ms,
            name="search-service", obs=self.obs)

    # ------------------------------------------------------------------
    def submit(self, query, q_vals=None, *,
               options: Optional[QueryOptions] = None) -> Future:
        """Non-blocking: enqueue one query and return a Future.

        Typed form — ``submit(Query(ids, vals), options=QueryOptions(
        deadline_ms=..., tenant=...))`` — resolves to a
        ``SearchResponse`` (results + that request's QueryStats).
        Positional 1-D arrays still work as a deprecation shim and
        resolve to the bare ``SearchResult`` row (1-D ``[k]``).

        Scheduling errors surface distinctly: admission sheds raise
        ``OverloadError`` *here, synchronously* (the request never
        queued — retry-after semantics belong to the caller); deadline
        expiry fails the *Future* with ``DeadlineExceeded`` (the
        request queued, then aged out)."""
        q, options = coerce_request(query, q_vals, options, surface="submit")
        q_ids, q_vals = q.flat()
        fut: Future = Future()
        deadline = None
        priority = 0
        if options is not None:
            if options.deadline_ms is not None:
                deadline = time.monotonic() + options.deadline_ms / 1e3
            priority = options.priority
        if self.admission is not None:
            release = self.admission.admit(
                options.tenant if options is not None else "default")
            fut.add_done_callback(lambda _f: release())
        req = _Request(q_ids, q_vals, fut, options=options,
                       deadline=deadline, priority=priority)
        try:
            self._batcher.submit(req)
        except RuntimeError:
            fut.cancel()                 # fires the admission release
            raise
        return fut

    def search(self, query, q_vals=None, *,
               options: Optional[QueryOptions] = None):
        """Blocking convenience wrapper: one query through the coalescer
        (it may share its batch with concurrent submitters)."""
        return self.submit(query, q_vals, options=options).result()

    @property
    def stats(self) -> BatcherStats:
        return self._batcher.stats

    @property
    def pending_count(self) -> int:
        return self._batcher.pending_count

    def shed_counts(self):
        """Admission sheds by reason ({} when admission is off)."""
        return self.admission.shed_counts() if self.admission else {}

    @property
    def cache_stats(self):
        """The backing searcher's slab-cache lifetime counters
        (DESIGN.md §4.2) — None for the resident engine, which keeps
        its whole corpus device-resident and has no storage tier."""
        return getattr(self.searcher, "cache_stats", None)

    @property
    def last_trace(self):
        """The backing searcher's most recent sampled QueryTrace (the
        batch's trace, annotated with its clients' queue waits)."""
        return getattr(self.searcher, "last_trace", None)

    @property
    def lockstep_stats(self) -> Optional[lockstep.LockstepStats]:
        """The leader's record and batch counts on a mesh, else None."""
        return self._lockstep.stats if self._lockstep is not None else None

    def close(self):
        self._batcher.close()
        if self._lockstep is not None:
            self._lockstep.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _score(self, qi: np.ndarray, qv: np.ndarray,
               opts: Optional[QueryOptions]):
        """Dispatch one stacked batch to the searcher. Typed surfaces
        (``search_typed``) get the folded batch options — that's how a
        deadline reaches the cluster gather; plain ``search(qi, qv)``
        searchers (the engine, duck-typed test searchers) see the
        legacy positional call."""
        typed = getattr(self.searcher, "search_typed", None)
        if self._lockstep is not None:
            return typed(Query(qi, qv), options=opts,
                         _lockstep=self._lockstep)
        if typed is not None:
            return typed(Query(qi, qv), options=opts)
        return self.searcher.search(qi, qv)

    def _run_batch(self, reqs: List[_Request]) -> None:
        """Scheduler-thread body: stack -> score -> demux. Runs entirely
        on the batcher thread, so the searcher sees serialized calls."""
        # claim every future first: a client that cancelled while queued
        # is dropped here, and claiming makes later cancel() a no-op so
        # the demux set_result below can never race an InvalidStateError
        # (which would otherwise fail the whole batch's clients)
        reqs = [r for r in reqs if r.future.set_running_or_notify_cancel()]
        if not reqs:
            return
        # per-request serving accounting (queue wait + scoring wall):
        # the serve-surface query_ms series feeds the latency SLO the
        # same way the session tiers feed store/cluster (DESIGN.md
        # §8.4). Guarded so Obs.disabled() reads no clock.
        timed = self.obs is not None and getattr(self.obs, "enabled", False)
        t0 = time.perf_counter() if timed else 0.0
        try:
            Qn = max(max(r.q_ids.size for r in reqs), 1)
            qi = np.full((len(reqs), Qn), -1, np.int32)
            qv = np.zeros((len(reqs), Qn), np.float32)
            for l, r in enumerate(reqs):
                qi[l, :r.q_ids.size] = r.q_ids
                qv[l, :r.q_vals.size] = r.q_vals
            before = getattr(self.searcher, "last_trace", None)
            res = self._score(qi, qv, _batch_options(reqs, time.monotonic()))
            # if the tracer sampled THIS batch's query, stitch the serve
            # stage in: the clients' queue waits become root attrs
            after = getattr(self.searcher, "last_trace", None)
            waits = [r.queue_wait_ms for r in reqs]
            if after is not None and after is not before and waits:
                after.root.set(
                    batch_size=len(reqs),
                    queue_wait_ms_max=round(max(waits), 3),
                    queue_wait_ms_mean=round(sum(waits) / len(waits), 3))
        except BaseException as e:
            if timed:
                reg = self.obs.registry
                # the whole batch's clients see the failure: each is one
                # bad event on the serve availability SLO
                reg.counter("queries_total", surface="serve").inc(len(reqs))
                reg.counter("query_errors_total",
                            surface="serve").inc(len(reqs))
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        if timed:
            wall_ms = (time.perf_counter() - t0) * 1e3
            reg = self.obs.registry
            h = reg.histogram("query_ms", surface="serve")
            for l in range(len(reqs)):
                h.observe(wall_ms + waits[l])
            reg.counter("queries_total", surface="serve").inc(len(reqs))
        # cluster-level scheduling outcomes for this batch (partial
        # merge? hedge won?) ride on the searcher's last_stats; demux
        # mirrors them into each opted-in request's QueryStats
        cl = getattr(self.searcher, "last_stats", None)
        partial = bool(getattr(cl, "partial", False))
        missing = tuple(getattr(cl, "shards_missing", ()) or ())
        hedged = bool(getattr(cl, "hedge_wins", 0))
        for l, r in enumerate(reqs):
            row = SearchResult(doc_ids=np.array(res.doc_ids[l]),
                               scores=np.array(res.scores[l]))
            if r.options is None:
                r.future.set_result(row)
                continue
            row = truncate_k(row, r.options.k)
            r.future.set_result(SearchResponse(row, QueryStats(
                queue_wait_ms=round(r.queue_wait_ms, 3),
                partial=partial, hedged=hedged, shards_missing=missing,
                deadline_ms=r.options.deadline_ms,
                tenant=r.options.tenant)))


def follow(searcher) -> lockstep.LockstepStats:
    """On a follower rank of a mesh: score every batch that rank 0's
    ``SearchService`` over the same searcher broadcasts (through
    ``searcher.follow_record``), until that service closes. Returns this
    rank's counts."""
    return lockstep.follow(getattr(searcher, "ctx", None),
                           searcher.follow_record)
