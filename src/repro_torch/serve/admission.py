"""Admission control: per-tenant token-bucket quotas + a bounded
pending queue that sheds instead of hanging (DESIGN.md §7.3).

The paper's pitch is *bounded, predictable* throughput; an unbounded
FIFO queue makes every latency percentile a function of the backlog,
so overload must be refused at the door, not absorbed. The controller
makes two checks under one lock, both O(1):

  1. **pending bound** — at most ``max_pending`` admitted requests may
     be outstanding (queued or scoring). Beyond it, ``admit`` raises a
     typed :class:`~repro_torch.serve.api.OverloadError` (``reason=
     "queue_full"``) — the caller gets an immediate, attributable shed,
     never a hang, and the batcher's EDF queue stays short enough that
     deadlines remain meetable.
  2. **tenant quota** — a token bucket per tenant (``rate`` tokens/s,
     ``burst`` capacity, lazily refilled from the injected clock — the
     same monotonic clock the rolling-window instruments use, so quota
     refill and window rotation age together in tests). A dry bucket
     sheds with ``reason="quota"`` so one hot tenant cannot starve the
     rest (the skewed/repetitive workloads of PAPERS.md "Leveraging
     Recurrent Patterns" are exactly the risk).

Shed decisions feed the shared registry: ``serve_shed_total{reason,
tenant}`` counters and the live ``serve_queue_depth`` gauge, so the
telemetry plane sees overload as a first-class signal.

``admit`` returns a zero-arg ``release`` callable; the service attaches
it as the Future's done-callback, so every admitted request — served,
failed, expired, or cancelled — gives its slot back exactly once.

A copy of ``repro.serve.admission`` (host work only).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

from repro_torch.obs import NULL_REGISTRY
from repro_torch.serve.api import OverloadError


class TokenBucket:
    """Classic token bucket, lock-free (callers serialize): ``rate``
    tokens/s refill up to ``burst``; ``try_take`` refills lazily from
    the injected clock read, so an idle bucket costs nothing."""

    def __init__(self, rate: float, burst: Optional[float] = None):
        if rate <= 0:
            raise ValueError(f"rate must be > 0 tokens/s, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(1.0, rate)
        if self.burst < 1.0:
            raise ValueError(f"burst must be >= 1 token, got {self.burst}")
        self.tokens = self.burst
        self._last: Optional[float] = None

    def try_take(self, now: float) -> bool:
        if self._last is not None:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class AdmissionController:
    """Thread-safe front door for a SearchService (DESIGN.md §7.3).

    ``max_pending`` bounds admitted-but-unfinished requests (None =
    unbounded); ``tenant_qps``/``tenant_burst`` set the default
    per-tenant quota applied to any tenant not named in ``quotas``
    (None = unmetered); ``quotas`` maps tenant -> (qps, burst) for
    explicit overrides. With every knob at None the controller admits
    everything — constructing one is never a behavior change by itself.
    """

    def __init__(self, *, max_pending: Optional[int] = None,
                 tenant_qps: Optional[float] = None,
                 tenant_burst: Optional[float] = None,
                 quotas: Optional[Dict[str, Tuple[float, float]]] = None,
                 registry=None, clock=time.monotonic):
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        self._default_quota = (tenant_qps, tenant_burst)
        self._quota_spec = dict(quotas or {})
        self._buckets: Dict[str, Optional[TokenBucket]] = {}
        self._clock = clock
        self._lock = threading.Lock()
        self._depth = 0
        # local shed tally (the registry may be NULL — its counters
        # no-op — but shed_counts() must still report truthfully)
        self._sheds = {"queue_full": 0, "quota": 0}
        reg = registry if registry is not None else NULL_REGISTRY
        self._g_depth = reg.gauge("serve_queue_depth")
        self._c_shed = {
            reason: reg.counter("serve_shed_total", reason=reason)
            for reason in ("queue_full", "quota")}
        self._c_admit = reg.counter("serve_admitted_total")

    # ------------------------------------------------------------------
    def _bucket(self, tenant: str) -> Optional[TokenBucket]:
        """Lazily built per-tenant bucket; caller holds the lock. None =
        this tenant is unmetered (no default and no explicit quota)."""
        if tenant not in self._buckets:
            if tenant in self._quota_spec:
                qps, burst = self._quota_spec[tenant]
                self._buckets[tenant] = TokenBucket(qps, burst)
            elif self._default_quota[0] is not None:
                self._buckets[tenant] = TokenBucket(*self._default_quota)
            else:
                self._buckets[tenant] = None
        return self._buckets[tenant]

    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth

    def admit(self, tenant: str = "default") -> Callable[[], None]:
        """Admit one request or shed it with a typed ``OverloadError``
        (synchronously — shedding never blocks, never hangs). Returns
        the release callable the caller must invoke exactly once when
        the request leaves the system (attach it as the Future's
        done-callback so served/failed/expired/cancelled all count)."""
        now = self._clock()
        with self._lock:
            if (self.max_pending is not None
                    and self._depth >= self.max_pending):
                self._sheds["queue_full"] += 1
                self._c_shed["queue_full"].inc()
                raise OverloadError(
                    f"pending queue full ({self._depth}/"
                    f"{self.max_pending}); request shed",
                    tenant=tenant, reason="queue_full",
                    depth=self._depth, limit=self.max_pending)
            bucket = self._bucket(tenant)
            if bucket is not None and not bucket.try_take(now):
                self._sheds["quota"] += 1
                self._c_shed["quota"].inc()
                raise OverloadError(
                    f"tenant {tenant!r} over quota "
                    f"({bucket.rate:g}/s, burst {bucket.burst:g}); "
                    f"request shed",
                    tenant=tenant, reason="quota",
                    depth=self._depth, limit=self.max_pending)
            self._depth += 1
            depth = self._depth
        self._c_admit.inc()
        self._g_depth.set(depth)
        released = threading.Event()     # exactly-once guard

        def release() -> None:
            if released.is_set():
                return
            released.set()
            with self._lock:
                self._depth -= 1
                depth = self._depth
            self._g_depth.set(depth)

        return release

    def shed_counts(self) -> Dict[str, int]:
        """Lifetime sheds by reason (a local tally, so it is truthful
        with or without a live registry)."""
        with self._lock:
            return dict(self._sheds)
