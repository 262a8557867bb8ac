"""Mean queries a coalesced batch (``serve/search_service.py``): the
service's ``stats.mean_occupancy`` over the window."""


def read(rec):
    if rec.stats is None or not rec.stats.n_batches:
        return None
    return rec.stats.mean_occupancy
