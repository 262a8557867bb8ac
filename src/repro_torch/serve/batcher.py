"""Micro-batch coalescing scheduler (DESIGN.md §7.1, §7.3).

The paper's headline amortization is one corpus pass per L-query merged
batch (Table 2); the serving-layer analogue is a scheduler that turns
many concurrent single-query clients into those L-column batches. A
single scheduler thread owns the pending set and flushes it when

  - it reaches ``max_batch`` requests (the engine's L), or
  - the *oldest* pending request has waited ``max_delay_ms``, or
  - the *nearest deadline* in the set would miss if the flush waited
    any longer (deadline minus the EWMA-estimated batch service time)

whichever comes first — bounded batching delay under light load, full
batches under heavy load, early flushes under deadline pressure. The
pending set is EDF-ordered (DESIGN.md §7.3): requests sort by
``(priority, deadline, submission order)`` — lower priority class
first, earliest deadline first within a class, FIFO within a tie — so
a full-batch flush takes the most urgent ``max_batch`` requests, not
the oldest. Requests without deadline or priority keep exactly the
legacy FIFO behavior (their key is ``(0, +inf, seq)``).

A request whose deadline has already passed when its batch forms is
dropped with a typed ``DeadlineExceeded`` *before* any device work —
nobody is waiting for that answer, and scoring it would delay the
requests that can still make their deadlines.

``MicroBatcher`` stays generic: it coalesces opaque request objects —
deadlines/priorities are read through injectable ``deadline_of`` /
``priority_of`` extractors (default: ``request.deadline`` as an
*absolute* ``time.monotonic`` instant, ``request.priority``) — and
hands each flushed batch (a list) to ``run_batch``, which completes the
requests' futures. A ``run_batch`` exception fails only that batch's
requests; the scheduler keeps serving.

Invariants the stress tests pin down (tests/test_serve_stress.py):
every submitted request lands in exactly one batch (or is dropped with
a typed error), batches preserve per-client submission order,
``close()`` drains pending requests, and ``submit`` after close raises
instead of dropping work silently. Flush accounting — reason counters,
``last_queue_waits_ms``, occupancy — is recorded under the batcher
lock in the same critical section that takes ownership of the batch,
so two flushes can never interleave their stats.

A copy of ``repro.serve.batcher``. In a ``SearchService`` its one
scheduler thread runs every search, so every launch of a served
query is made from that thread.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import math
import queue
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.obs import NULL_REGISTRY, Obs
from repro_torch.serve.api import DeadlineExceeded

_SHUTDOWN = object()

# recent batch sizes kept for inspection; bounded so a long-lived
# service doesn't grow a list forever (means come from running totals)
_OCCUPANCY_WINDOW = 4096

# EWMA smoothing for the batch service-time estimate that drives early
# deadline flushes: new = (1-ALPHA)*old + ALPHA*sample. 0.25 tracks a
# shifting service time within ~8 batches without chasing one outlier.
_SERVICE_EWMA_ALPHA = 0.25

# fixed safety margin under the deadline flush: with a cold (zero)
# service estimate the flush would otherwise land exactly ON the
# nearest deadline — and the expiry check would drop the very request
# the early flush was trying to save
_DEADLINE_GUARD_S = 2e-3


def _default_deadline_of(request: Any) -> Optional[float]:
    """Absolute ``time.monotonic`` deadline, or None (no deadline)."""
    return getattr(request, "deadline", None)


def _default_priority_of(request: Any) -> int:
    return getattr(request, "priority", 0) or 0


@dataclasses.dataclass
class BatcherStats:
    n_requests: int = 0
    n_batches: int = 0
    n_expired: int = 0                           # deadline drops
    flushes: Optional[Dict[str, int]] = None     # reason -> count
    occupancy: Optional[Deque[int]] = None       # recent batch sizes

    def __post_init__(self):
        self.flushes = self.flushes or {"full": 0, "timeout": 0,
                                        "deadline": 0, "drain": 0}
        if self.occupancy is None:
            self.occupancy = collections.deque(maxlen=_OCCUPANCY_WINDOW)

    @property
    def mean_occupancy(self) -> float:
        return self.n_requests / self.n_batches if self.n_batches else 0.0


class _Entry:
    """One pending request with its EDF heap key: lower priority class
    first, earlier deadline first within a class (None sorts last),
    submission order as the tiebreak — so legacy no-deadline requests
    coalesce in exactly the old FIFO order."""
    __slots__ = ("key", "seq", "t_sub", "request", "deadline")

    def __init__(self, seq: int, t_sub: float, request: Any,
                 priority: int, deadline: Optional[float]):
        self.key = (priority, deadline if deadline is not None else math.inf,
                    seq)
        self.seq = seq
        self.t_sub = t_sub
        self.request = request
        self.deadline = deadline

    def __lt__(self, other: "_Entry") -> bool:
        return self.key < other.key


class MicroBatcher:
    def __init__(self, run_batch: Callable[[List[Any]], None], *,
                 max_batch: int = 8, max_delay_ms: float = 2.0,
                 name: str = "micro-batcher",
                 obs: Optional[Obs] = None,
                 deadline_of: Callable[[Any], Optional[float]] = None,
                 priority_of: Callable[[Any], int] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_delay_ms < 0:
            raise ValueError("max_delay_ms must be >= 0")
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self._run_batch = run_batch
        self._deadline_of = deadline_of or _default_deadline_of
        self._priority_of = priority_of or _default_priority_of
        self._q: "queue.Queue" = queue.Queue()
        self._seq = itertools.count()
        self._closed = False
        self._lock = threading.Lock()
        self._n_queued = 0               # submitted, not yet flushed/dropped
        self.stats = BatcherStats()
        # EWMA of run_batch wall time (s), the service estimate behind
        # early deadline flushes; starts at 0 (optimistic) and converges
        # within a few batches
        self._service_est_s = 0.0
        # §8 registry handles (resolved once — the scheduler loop only
        # touches pre-bound instruments); NULL when no obs is shared
        reg = obs.registry if obs is not None else NULL_REGISTRY
        self._h_wait = reg.histogram("serve_queue_wait_ms")
        self._h_occ = reg.histogram(
            "serve_batch_occupancy",
            buckets=(1., 2., 4., 8., 16., 32., 64., 128.))
        self._c_flush = {reason: reg.counter("serve_flushes", reason=reason)
                         for reason in ("full", "timeout", "deadline",
                                        "drain")}
        self._c_expired = reg.counter("serve_deadline_dropped_total")
        # queue waits (ms) of the most recent flush, written under the
        # batcher lock in the same critical section that takes the batch
        # — run_batch bodies (e.g. SearchService) may read it to
        # annotate traces
        self.last_queue_waits_ms: List[float] = []
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, request: Any) -> None:
        """Enqueue one request for an upcoming batch. Thread-safe. The
        request is timestamped here, so the max_delay_ms bound is
        measured from submission — time spent queued behind an
        in-flight batch counts against the delay budget. A request
        whose deadline is already past is failed here with
        ``DeadlineExceeded(where="submit")`` and never enqueued."""
        now = time.monotonic()
        deadline = self._deadline_of(request)
        if deadline is not None and now >= deadline:
            self._expire(request, now, where="submit")
            return
        entry = _Entry(next(self._seq), now, request,
                       int(self._priority_of(request)), deadline)
        with self._lock:
            if self._closed:
                raise RuntimeError("submit() on a closed MicroBatcher")
            self._n_queued += 1
            self._q.put(entry)

    @property
    def pending_count(self) -> int:
        """Requests submitted but not yet handed to ``run_batch`` (nor
        dropped as expired) — the live queue depth."""
        with self._lock:
            return self._n_queued

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop accepting requests, drain what is pending, join the
        scheduler thread (by default without a timeout: returning while
        a batch is still scoring would let the caller tear down
        resources — stores, devices — out from under it). Idempotent."""
        with self._lock:
            if self._closed:
                already = True
            else:
                already = False
                self._closed = True
                self._q.put(_SHUTDOWN)
        if not already:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    "MicroBatcher scheduler still running after "
                    f"{timeout}s; resources must not be torn down yet")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _expire(self, request: Any, now: float, *, where: str) -> None:
        """Drop one expired request: typed error on its future, drop
        counters. Called before any device work is spent on it."""
        deadline = self._deadline_of(request)
        late_ms = (now - deadline) * 1e3 if deadline is not None else 0.0
        with self._lock:
            self.stats.n_expired += 1
        self._c_expired.inc()
        fut = getattr(request, "future", None)
        if fut is not None and fut.set_running_or_notify_cancel():
            fut.set_exception(DeadlineExceeded(
                f"deadline passed {late_ms:.1f}ms ago "
                f"({'at submit' if where == 'submit' else 'while queued'}); "
                f"request dropped before scoring",
                late_ms=late_ms, where=where))

    def _flush(self, heap: List[_Entry], reason: str) -> None:
        """Take the ``max_batch`` most urgent pending entries (EDF
        order), drop the expired ones, run the rest. Flush accounting
        happens under the batcher lock in the same critical section
        that claims the batch, so concurrent readers of
        ``last_queue_waits_ms``/``stats`` can never see two flushes
        interleaved."""
        now = time.monotonic()
        batch: List[_Entry] = []
        while heap and len(batch) < self.max_batch:
            e = heapq.heappop(heap)
            if e.deadline is not None and now >= e.deadline:
                with self._lock:
                    self._n_queued -= 1
                self._expire(e.request, now, where="queue")
                continue
            batch.append(e)
        if not batch:
            return
        # heap pops come out in key order, so equal-key (legacy FIFO)
        # requests keep their exact arrival order within the batch
        waits = [(now - e.t_sub) * 1e3 for e in batch]
        with self._lock:
            self._n_queued -= len(batch)
            self.last_queue_waits_ms = waits
            self.stats.n_batches += 1
            self.stats.n_requests += len(batch)
            self.stats.flushes[reason] += 1
            self.stats.occupancy.append(len(batch))
        for w in waits:
            self._h_wait.observe(w)
        self._h_occ.observe(len(batch))
        self._c_flush[reason].inc()
        requests = []
        for e, w in zip(batch, waits):
            try:
                e.request.queue_wait_ms = w
            except AttributeError:
                pass                     # slot-less/opaque requests
            requests.append(e.request)
        t0 = time.monotonic()
        try:
            self._run_batch(requests)
        except BaseException as e:
            # run_batch is expected to fail its requests' futures itself;
            # this is the backstop for errors it did not attribute
            for r in requests:
                fut = getattr(r, "future", None)
                if fut is not None and not fut.done():
                    fut.set_exception(e)
        wall = time.monotonic() - t0
        self._service_est_s += _SERVICE_EWMA_ALPHA * (wall
                                                      - self._service_est_s)

    def _topup(self, heap: List[_Entry]) -> bool:
        """Non-blocking: absorb whatever is already queued. An overdue
        flush must still coalesce the backlog that accumulated behind
        the previous batch — those requests are here *now*, so batching
        them delays nobody. (The heap may exceed max_batch; the flush
        takes the most urgent max_batch and leaves the rest pending.)
        True if shutdown was hit."""
        while True:
            try:
                entry = self._q.get_nowait()
            except queue.Empty:
                return False
            if entry is _SHUTDOWN:
                return True
            heapq.heappush(heap, entry)

    def _flush_at(self, heap: List[_Entry], oldest_sub: float
                  ) -> Tuple[float, str]:
        """When the pending set must flush and why: the oldest
        request's delay budget, or earlier if the nearest deadline
        would miss given the estimated service time."""
        t_timeout = oldest_sub + self.max_delay
        nearest = min((e.deadline for e in heap if e.deadline is not None),
                      default=None)
        if nearest is not None:
            t_deadline = nearest - self._service_est_s - _DEADLINE_GUARD_S
            if t_deadline < t_timeout:
                return t_deadline, "deadline"
        return t_timeout, "timeout"

    def _loop(self) -> None:
        heap: List[_Entry] = []
        oldest_sub = 0.0
        while True:
            if not heap:
                entry = self._q.get()    # idle: block until work arrives
                if entry is _SHUTDOWN:
                    return
                heapq.heappush(heap, entry)
                # the delay budget started at submit time, not dequeue:
                # a request that already waited behind a long batch
                # flushes promptly instead of waiting a fresh max_delay
                oldest_sub = entry.t_sub
            else:
                flush_at, why = self._flush_at(heap, oldest_sub)
                timeout = flush_at - time.monotonic()
                if timeout <= 0:
                    shutdown = self._topup(heap)
                    self._flush(heap, "full" if len(heap) >= self.max_batch
                                else why)
                    oldest_sub = min((e.t_sub for e in heap),
                                     default=0.0)
                    if shutdown:
                        while heap:      # drain whatever close() raced in
                            self._flush(heap, "drain")
                        return
                    continue
                try:
                    entry = self._q.get(timeout=timeout)
                except queue.Empty:
                    self._flush(heap, why)
                    oldest_sub = min((e.t_sub for e in heap), default=0.0)
                    continue
                if entry is _SHUTDOWN:
                    while heap:
                        self._flush(heap, "drain")
                    return
                heapq.heappush(heap, entry)
                oldest_sub = min(oldest_sub, entry.t_sub)
            shutdown = False
            while len(heap) >= self.max_batch and not shutdown:
                # absorb the rest of the backlog first, so a full flush
                # takes the most urgent max_batch of EVERYTHING queued
                # (EDF), not just the earliest arrivals — and keep
                # flushing while a full batch remains (the leftovers
                # must not wait out a fresh max_delay)
                shutdown = self._topup(heap)
                self._flush(heap, "full")
            oldest_sub = min((e.t_sub for e in heap), default=oldest_sub)
            if shutdown:
                while heap:
                    self._flush(heap, "drain")
                return
