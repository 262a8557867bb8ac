"""The whole scoring pass's share of its roofline, in %: the sum over the
traced batches of each pass's least time (``roofline.py``: the corpus as
Fig. 8 words, the merged query stream, the [L, k] answer; 2 operations a
matched (pair, query column) product) over the device's busy time."""


def read(rec):
    least = [s[3] for s in rec.spans]
    if not least or None in least or rec.busy_s <= 0:
        return None
    return 100.0 * sum(least) / rec.busy_s
