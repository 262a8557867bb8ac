"""Mean wall ms of one call into the searcher (the engine's
``search_streaming`` on the slab): the harness's own span around each
batch, on the host clock."""


def read(rec):
    if not rec.spans:
        return None
    return sum(t1 - t0 for t0, t1, _, _ in rec.spans) * 1e3 / len(rec.spans)
