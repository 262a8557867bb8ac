"""Shared serving surface for storage-backed search sessions
(DESIGN.md §7.3).

FlashSearchSession (one store) and FlashClusterSession (N shards)
promise the same ``service`` / ``submit`` / ``close`` surface; this
mixin is that surface, so the two cannot drift. Host classes implement
``search(q_ids [L, Qn], q_vals [L, Qn]) -> SearchResult`` and
``_close_resources()`` and call ``_init_serving()`` from ``__init__``.

A copy of ``repro.serve.session_surface``; ``start_telemetry()`` serves
the port's telemetry server (``repro_torch.obs.server``), whose
``/debug/profile`` records the session's device.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future


class ServingSessionMixin:
    def _init_serving(self):
        self._service = None
        self._service_lock = threading.Lock()
        self._closed = False
        self._telemetry = None

    def start_telemetry(self, *, port: int = 0, host: str = "127.0.0.1",
                        slo_monitor=None, profile_dir=None):
        """Start the live telemetry plane for this session (DESIGN.md
        §8.5): an HTTP thread serving /metrics, /healthz, /slo,
        /debug/traces and, with ``profile_dir``, /debug/profile off the
        session's ``Obs`` bundle, with the
        session's health surfaces (router replicas, ingest liveness)
        registered. One server per session; a second call returns the
        running one. Closed with the session."""
        with self._service_lock:
            if self._closed:
                raise RuntimeError(f"{type(self).__name__} is closed")
            if self._telemetry is None:
                from repro_torch.obs.server import start_telemetry
                self._telemetry = start_telemetry(
                    self, port=port, host=host, slo_monitor=slo_monitor,
                    profile_dir=profile_dir)
            return self._telemetry

    @property
    def telemetry(self):
        """The running TelemetryServer, or None."""
        return self._telemetry

    def service(self, *, max_batch: int = 8, max_delay_ms: float = 2.0,
                admission=None, max_pending=None, tenant_qps=None,
                tenant_burst=None):
        """The session's lazily-created SearchService (DESIGN.md §7):
        one micro-batching scheduler whose flushed batches run
        ``self.search`` — each coalesced batch costs one pass over the
        backing store(s) instead of one per client. The knobs apply on
        first call; later calls return the same service. The admission
        knobs (DESIGN.md §7.3) bound the pending queue and meter
        tenants; all-None keeps the legacy admit-everything door."""
        with self._service_lock:
            if self._closed:
                raise RuntimeError(f"{type(self).__name__} is closed")
            if self._service is None:
                from repro_torch.serve.search_service import SearchService
                self._service = SearchService(
                    self, max_batch=max_batch, max_delay_ms=max_delay_ms,
                    admission=admission, max_pending=max_pending,
                    tenant_qps=tenant_qps, tenant_burst=tenant_burst)
            return self._service

    def submit(self, query, q_vals=None, *, options=None) -> Future:
        """Non-blocking single-query search: route one query through
        the session's coalescing service and return its Future. Also the
        thread-safe entry point — the scheduler serializes scoring, so
        non-thread-safe session internals are never raced.

        Typed form ``submit(Query(...), options=QueryOptions(...))``
        resolves to a ``SearchResponse``; positional ``(q_ids, q_vals)``
        arrays remain as a deprecation shim resolving to the bare
        ``SearchResult`` row (see serve/api.py)."""
        return self.service().submit(query, q_vals, options=options)

    def follow(self):
        """On a follower rank of a mesh (any rank but 0): score each batch
        that rank 0's service over this session broadcasts, until it
        closes (``distributed/lockstep.py``). Blocks; returns this rank's
        ``LockstepStats``. ``service`` and ``submit`` raise there."""
        with self._service_lock:
            if self._closed:
                raise RuntimeError(f"{type(self).__name__} is closed")
        from repro_torch.serve.search_service import follow
        return follow(self)

    def close(self):
        """Idempotent: only the first close tears down the session's
        resources (store/pipeline/router); later calls are no-ops, so a
        router teardown racing a user close cannot double-free."""
        with self._service_lock:
            first = not self._closed
            self._closed = True
            if self._service is not None:
                self._service.close()
                self._service = None
            telemetry, self._telemetry = self._telemetry, None
        if telemetry is not None:
            telemetry.close()
        if first:
            self._close_resources()

    def _close_resources(self):
        raise NotImplementedError

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
