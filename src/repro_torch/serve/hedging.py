"""Replica hedging: fire a straggling shard query at the next replica
and take whichever answers first (DESIGN.md §7.3).

A scatter/gather is as slow as its slowest shard, and shard latency in
this tree has a long tail (cold slab cache, compactor stalls, a busy
device). Hedging converts that tail into a second chance: when a
replica attempt has run longer than the *straggler threshold*, the same
query is launched at the next in-rotation replica and the first result
wins. Replicas are byte-wise independent copies of the same shard
(cluster/store.py), so either answer is correct and bit-identical —
hedging changes *when* the result arrives, never *what* it is.

The threshold is seeded from live telemetry, closing the PR-8 loop:
``HedgePolicy.hedge_after_ms`` reads the rolling-window twin of the
router's ``cluster_shard_ms`` histogram and takes a configurable
percentile of the *recent* shard latency distribution (default p95 —
"slower than 19 of 20 recent shard calls ⇒ probably stuck, not slow").
With no window yet populated (cold start, windows disabled) it falls
back to a fixed ``fallback_ms``.

The mechanics live in ``run_hedged``: a primary attempt plus a timer
that launches the hedge only if the primary is still running at the
threshold. First completion wins; the loser is cancelled best-effort
(Python can't interrupt a running scoring call, so a started loser
runs to completion on its executor and is discarded — callers that
care about session reuse must make attempts self-serializing, which
the router's per-replica locks do). A hedge *winning* is recorded
distinctly from a hedge merely *firing*; neither marks the slow
replica down — slow is not failed, and health marking stays the
fail-over path's job.

A copy of ``repro.serve.hedging``, host threads only. On the card a
losing attempt that has started keeps scoring until it ends: its
launches queue on the same stream as the winner's (the router's
docstring says which), and ``SpawnExecutor.shutdown`` joins it before a
replica session and its slabs are closed.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import FIRST_COMPLETED, Future, wait
from typing import Callable, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    """When to fire the second attempt.

    percentile    straggler threshold as a quantile of the recent
                  (rolling-window) ``cluster_shard_ms`` distribution
    min_ms        floor under the percentile — never hedge faster than
                  this, so a uniformly-fast window can't make every
                  query fire two attempts
    fallback_ms   threshold when no window data exists yet (cold start,
                  or the registry has windows disabled)
    """
    percentile: float = 0.95
    min_ms: float = 1.0
    fallback_ms: float = 50.0

    def __post_init__(self):
        if not 0.0 < self.percentile < 1.0:
            raise ValueError(
                f"percentile must be in (0, 1), got {self.percentile}")
        if self.min_ms < 0 or self.fallback_ms <= 0:
            raise ValueError("min_ms must be >= 0 and fallback_ms > 0")

    def hedge_after_ms(self, registry) -> float:
        """Current straggler threshold, seeded from the rolling-window
        shard-latency histogram when it has data."""
        win = registry.windowed("cluster_shard_ms") \
            if registry is not None else None
        if win is not None:
            p = win.percentile(self.percentile)
            if p > 0.0:
                return max(self.min_ms, p)
        return max(self.min_ms, self.fallback_ms)


@dataclasses.dataclass
class HedgeOutcome:
    """What one hedged call did. ``winner_index`` indexes ``fns``;
    ``hedge_won`` is True only when a timer-fired attempt (index >= 1)
    delivered the result — a hedge that fired but lost is visible as
    ``hedges_fired > 0, hedge_won=False``."""
    winner_index: int
    result: object
    hedges_fired: int = 0
    hedge_won: bool = False
    errors: List[Optional[BaseException]] = dataclasses.field(
        default_factory=list)


class SpawnExecutor:
    """Executor-shaped launcher that gives every attempt its own daemon
    thread. Hedge attempts must never queue behind other attempts: on a
    bounded pool an abandoned loser still sleeping inside a straggler
    holds a worker, and the next query's hedge then waits *for the very
    straggler it was meant to outrun* — under sustained traffic the
    timer fires but the winning attempt can't start inside the deadline
    budget. One thread per submit keeps the timer honest; the live
    thread count is bounded by in-flight attempts (losers exit when
    their per-replica-serialized call returns)."""

    def __init__(self):
        self._threads: set = set()
        self._lock = threading.Lock()

    def submit(self, fn: Callable[[], object]) -> Future:
        fut: Future = Future()

        def run():
            try:
                if not fut.set_running_or_notify_cancel():
                    return
                try:
                    fut.set_result(fn())
                except BaseException as e:
                    fut.set_exception(e)
            finally:
                with self._lock:
                    self._threads.discard(threading.current_thread())

        t = threading.Thread(target=run, daemon=True, name="hedge-attempt")
        with self._lock:
            self._threads.add(t)
        t.start()
        return fut

    def shutdown(self, wait: bool = True) -> None:
        """Join every in-flight attempt (abandoned losers included) so
        callers can close replica sessions without a late attempt
        touching a closed session."""
        if not wait:
            return
        while True:
            with self._lock:
                t = next(iter(self._threads), None)
            if t is None:
                return
            t.join()


def run_hedged(fns: Sequence[Callable[[], object]], executor, *,
               hedge_after_s: float,
               on_hedge: Optional[Callable[[int], None]] = None
               ) -> HedgeOutcome:
    """Run ``fns[0]`` on ``executor``; if it hasn't completed after
    ``hedge_after_s``, launch ``fns[1]`` (then ``fns[2]`` after another
    interval, ...) and return the first *successful* completion.

    Called from a router pool thread with attempts running on a
    *separate* executor — launching hedges back onto the caller's own
    pool would self-deadlock when every worker is blocked here waiting,
    and any *bounded* pool starves under sustained straggling (see
    ``SpawnExecutor``). An attempt that raises doesn't win: its error is
    recorded
    and the wait continues (launching the next attempt immediately if
    none is in flight — an error is a stronger hedge signal than a
    straggler). Only when every attempt has failed does the primary's
    error re-raise; per-attempt errors ride on the outcome for the
    caller's structured error context.

    Losing attempts are cancelled best-effort; a loser already running
    is discarded on completion (see module docstring for the session-
    serialization contract this implies).
    """
    if not fns:
        raise ValueError("run_hedged needs at least one attempt")
    errors: List[Optional[BaseException]] = [None] * len(fns)
    futs: List[Future] = [executor.submit(fns[0])]
    pending = {futs[0]}
    launched = 1
    hedges_fired = 0
    while True:
        # wait only on in-flight attempts (a completed-failed future
        # would make a whole-list FIRST_COMPLETED return immediately
        # and busy-spin); no timeout once every replica is launched
        timeout = hedge_after_s if launched < len(fns) else None
        done, pending = wait(pending, timeout=timeout,
                             return_when=FIRST_COMPLETED)
        for f in done:
            idx = futs.index(f)
            err = f.exception() if not f.cancelled() else None
            if err is None and not f.cancelled():
                for other in futs:
                    if other is not f:
                        other.cancel()
                return HedgeOutcome(
                    winner_index=idx, result=f.result(),
                    hedges_fired=hedges_fired, hedge_won=idx >= 1,
                    errors=errors)
            errors[idx] = err
        if launched < len(fns) and (not done or not pending):
            # timer expired with attempts still running, or everything
            # in flight just failed (an error is a stronger hedge
            # signal than a straggler): fire the next replica
            if on_hedge is not None:
                on_hedge(launched)
            nxt = executor.submit(fns[launched])
            futs.append(nxt)
            pending.add(nxt)
            launched += 1
            hedges_fired += 1
        elif not pending:
            # every attempt launched and failed
            raise next(e for e in errors if e is not None)


class CancelFlag:
    """Cooperative cancellation token for losing hedge attempts: the
    winner's thread sets it, a loser checks it at its next safe point
    (before touching its replica session) and bails without device
    work. Cheap, race-free (Event), and purely advisory."""

    def __init__(self):
        self._ev = threading.Event()

    def set(self) -> None:
        self._ev.set()

    def __bool__(self) -> bool:
        return self._ev.is_set()
