"""Device ms a batch in the configuration's match kernel (its
``match_kernel``: B1's ``table_kernel`` over ``EllDocs``, or B3's
``fused_kernel``), from the profiler's trace, over the batches traced."""
from searchbench import profread


def read(rec):
    s = profread.kernel_seconds(rec.intervals, rec.config["match_kernel"])
    if not rec.spans or s <= 0:
        return None
    return s * 1e3 / len(rec.spans)
