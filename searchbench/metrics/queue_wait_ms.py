"""Median wait of a query in the service's queue (``serve/batcher.py``),
in ms: the p50 of the registry's ``serve_queue_wait_ms`` histogram over
the window (the service starts with the window)."""


def read(rec):
    if rec.registry is None:
        return None
    h = rec.registry.histogram("serve_queue_wait_ms")
    return h.percentile(0.5) if h.count else None
