"""Per-segment inverted posting index — the approximate candidate tier
(DESIGN.md §15).

Every scoring path below this module is exhaustive-exact: a query pays
decode + correlate for every document of every segment the vocabulary
filter can't skip. SpANNS-style sparse search wins at scale by splitting
that into (1) cheap *candidate generation* near the data and (2) exact
re-ranking of a small pool. This module is phase 1: at segment-build
time the Fig. 8 stream is inverted into term -> (doc offset, quantized
weight) postings, stored in the segment file next to the vocabulary
filter; at query time an in-memory accumulator walks only the query
terms' posting lists and returns the per-segment top-C candidate pool.

On-disk layout (all little-endian uint32 words, Fig. 8 footer style —
the segment footer records ``{"off", "nbytes", "meta"}`` exactly like
the filter section):

    [n_terms | n_docs | n_postings | reserved]      4-word header
    [term_ids   u32 * n_terms]                      sorted, unique
    [offsets    u32 * (n_terms + 1)]                prefix sums
    [postings   u32 * n_postings]                   [doc_off:20 | w:12]
    [norms      f32 * n_docs]                       full-doc L2 norms
    [doc_starts u32 * (n_docs + 1)]                 item offset of each
                                                    doc's header in the
                                                    segment stream

``doc_starts`` is the gather side's row directory: a candidate doc
offset maps straight to its ``[start, end)`` item range in the Fig. 8
stream, so the re-rank reads and decodes *only the candidate
documents' bytes* — the in-storage "move only what matches" economy,
applied to the exact phase.

A posting packs the document's *offset within the segment* (20 bits —
bounded by ``MAX_SEGMENT_DOCS``, far above any docs_per_segment in use)
with the Fig. 8 12-bit saturating count, so one posting is one u32 and
the whole index is typically ~the stream's own size. Norms are stored
densely so the accumulator ranks by cosine-like score (dot / norm), the
same monotone ordering the exact path uses per query.

The candidate score is *approximate* in exactly two ways: counts
saturate at 4095 (as the stream itself does) and postings cover the
full document while the exact path scores rows truncated to
``nnz_pad`` — so the pool can miss a true winner, which is what the
recall@k axis (benchmarks/recall_bench.py) measures and the exact
re-rank stage (storage/plan.py) repairs for every candidate it does
contain.

A copy of ``repro.storage.postings``: ``to_bytes``/``from_bytes`` round-
trip across the two packages.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core import stream_format

KIND = "postings1"
OFF_BITS = 32 - stream_format.VAL_BITS      # 20-bit doc offsets
MAX_SEGMENT_DOCS = 1 << OFF_BITS
_VAL_BITS = stream_format.VAL_BITS
_VAL_MASK = stream_format.VAL_MASK


class PostingIndex:
    """Inverted index over one segment: sorted unique ``term_ids`` with
    CSR-style ``offsets`` into the packed ``postings`` array, plus the
    per-document norms the accumulator divides by."""

    def __init__(self, term_ids: np.ndarray, offsets: np.ndarray,
                 postings: np.ndarray, norms: np.ndarray,
                 doc_starts: np.ndarray):
        self.term_ids = term_ids        # uint32 [n_terms], sorted
        self.offsets = offsets          # uint32 [n_terms + 1]
        self.postings = postings        # uint32 [n_postings]
        self.norms = norms              # float32 [n_docs]
        self.doc_starts = doc_starts    # uint32 [n_docs + 1], item offsets

    @property
    def n_terms(self) -> int:
        return int(self.term_ids.size)

    @property
    def n_docs(self) -> int:
        return int(self.norms.size)

    @property
    def n_postings(self) -> int:
        return int(self.postings.size)

    @property
    def nbytes(self) -> int:
        return 4 * (4 + self.n_terms + (self.n_terms + 1)
                    + self.n_postings + self.n_docs + (self.n_docs + 1))

    # -- build ---------------------------------------------------------
    @classmethod
    def build(cls, stream: np.ndarray) -> "PostingIndex":
        """Invert a Fig. 8 uint32 stream. One pass, fully vectorized:
        every pair item becomes one posting keyed by its word id and
        attributed to its document's offset within the stream."""
        stream = np.asarray(stream, np.uint32)
        is_hdr = (stream & stream_format.HEADER_BIT) != 0
        n_docs = int(is_hdr.sum())
        if n_docs > MAX_SEGMENT_DOCS:
            raise ValueError(
                f"segment has {n_docs} docs; postings pack doc offsets "
                f"into {OFF_BITS} bits (max {MAX_SEGMENT_DOCS})")
        if n_docs == 0:
            return cls(np.empty(0, np.uint32), np.zeros(1, np.uint32),
                       np.empty(0, np.uint32), np.empty(0, np.float32),
                       np.zeros(1, np.uint32))
        doc_starts = np.append(np.flatnonzero(is_hdr),
                               stream.size).astype(np.uint32)
        doc_of_item = np.cumsum(is_hdr) - 1     # doc offset per item
        pair_mask = ~is_hdr
        pairs = stream[pair_mask]
        doc_off = doc_of_item[pair_mask].astype(np.uint32)
        words = ((pairs >> _VAL_BITS) & np.uint32(stream_format.KEY_MASK))
        counts = pairs & np.uint32(_VAL_MASK)
        # group by term, documents ascending inside each group (stable)
        order = np.argsort(words, kind="stable")
        words = words[order]
        packed = (doc_off[order] << np.uint32(_VAL_BITS)) | counts[order]
        term_ids, starts = np.unique(words, return_index=True)
        offsets = np.append(starts, words.size).astype(np.uint32)
        cf = counts.astype(np.float64)
        norms = np.sqrt(np.bincount(doc_off.astype(np.int64), cf * cf,
                                    minlength=n_docs)).astype(np.float32)
        return cls(term_ids.astype(np.uint32), offsets, packed, norms,
                   doc_starts)

    # -- (de)serialization — the segment footer embeds meta + raw ------
    def to_bytes(self) -> bytes:
        hdr = np.asarray([self.n_terms, self.n_docs, self.n_postings, 0],
                         np.uint32)
        return b"".join(a.astype("<u4").tobytes() if a.dtype != np.float32
                        else a.astype("<f4").tobytes()
                        for a in (hdr, self.term_ids, self.offsets,
                                  self.postings, self.norms,
                                  self.doc_starts))

    def meta(self) -> Dict:
        return {"kind": KIND, "n_terms": self.n_terms,
                "n_docs": self.n_docs, "n_postings": self.n_postings}

    @classmethod
    def from_bytes(cls, meta: Dict, raw: bytes) -> "PostingIndex":
        if meta["kind"] != KIND:
            raise ValueError(f"unknown postings kind {meta['kind']!r}")
        words = np.frombuffer(raw, "<u4")
        n_terms, n_docs, n_postings = (int(words[0]), int(words[1]),
                                       int(words[2]))
        o = 4
        term_ids = words[o:o + n_terms].astype(np.uint32)
        o += n_terms
        offsets = words[o:o + n_terms + 1].astype(np.uint32)
        o += n_terms + 1
        postings = words[o:o + n_postings].astype(np.uint32)
        o += n_postings
        norms = np.frombuffer(raw, "<f4", count=n_docs,
                              offset=4 * o).astype(np.float32)
        o += n_docs
        doc_starts = words[o:o + n_docs + 1].astype(np.uint32)
        return cls(term_ids, offsets, postings, norms, doc_starts)

    # -- the accumulator -----------------------------------------------
    def candidates(self, q_ids: np.ndarray, q_vals: np.ndarray,
                   n_cand: int) -> np.ndarray:
        """Top-C candidate pool for one query batch ``[L, Qn]``
        (pad < 0): walk only the query terms' posting lists, accumulate
        ``sum(q_val * count) / doc_norm`` per (row, doc), take the
        top-``n_cand`` docs per row and return the union as *sorted*
        doc offsets — ascending segment order, so the re-rank mini-slab
        preserves the exact scan's within-segment tie-breaking for
        every doc in the pool.

        Zero-score docs are eligible (argpartition over the full score
        vector): the exact path ranks no-overlap docs at score 0 above
        the -inf filler, so a pool that simply dropped them could never
        reproduce the exhaustive result even at C = n_docs.
        """
        n_docs = self.n_docs
        if n_docs == 0:
            return np.empty(0, np.int64)
        n_cand = max(1, min(int(n_cand), n_docs))
        q_ids = np.atleast_2d(q_ids)
        q_vals = np.atleast_2d(q_vals)
        L = q_ids.shape[0]
        rows, cols = np.nonzero(q_ids >= 0)
        acc = np.zeros((L, n_docs), np.float32)
        if rows.size and self.n_terms:
            terms = q_ids[rows, cols].astype(np.uint32)
            tvals = q_vals[rows, cols].astype(np.float32)
            ti = np.searchsorted(self.term_ids, terms)
            ti_safe = np.minimum(ti, self.n_terms - 1)
            hit = self.term_ids[ti_safe] == terms
            if hit.any():
                ti = ti_safe[hit]
                starts = self.offsets[ti].astype(np.int64)
                lens = self.offsets[ti + 1].astype(np.int64) - starts
                # grouped arange: flat indices of every posting touched
                out_starts = np.cumsum(lens) - lens
                total = int(lens.sum())
                flat = (np.arange(total, dtype=np.int64)
                        - np.repeat(out_starts, lens)
                        + np.repeat(starts, lens))
                p = self.postings[flat]
                d = (p >> np.uint32(_VAL_BITS)).astype(np.int64)
                w = (p & np.uint32(_VAL_MASK)).astype(np.float32)
                np.add.at(acc, (np.repeat(rows[hit], lens), d),
                          np.repeat(tvals[hit], lens) * w)
        acc /= np.maximum(self.norms, np.float32(1e-12))[None, :]
        if n_cand >= n_docs:
            return np.arange(n_docs, dtype=np.int64)
        top = np.argpartition(-acc, n_cand - 1, axis=1)[:, :n_cand]
        return np.unique(top.reshape(-1)).astype(np.int64)


def gather_rows(seg, doc_offs: np.ndarray, nnz_pad: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                           np.ndarray, int]:
    """Phase 2's gather: read and decode *only the candidate documents'
    item ranges*. The posting index's ``doc_starts`` directory maps
    every candidate doc offset straight to its ``[start, end)`` slice
    of the mmap-backed Fig. 8 stream, so the OS faults in only the file
    pages those slices touch and the decoder never sees a non-candidate
    item. Documents decode independently (each carries its own header),
    so the concatenated sub-stream's rows are bit-identical to the same
    rows of a full-stream decode — the exact re-rank inherits exactness
    from that.

    Returns ``(doc_ids, ids, vals, norms, n_truncated)`` with
    ``n_truncated`` counted over the *selected* rows only (the stats a
    full scan would have attributed to these documents)."""
    doc_offs = np.asarray(doc_offs, np.int64)
    if doc_offs.size == 0:
        return (np.empty(0, np.int64),
                np.full((0, nnz_pad), -1, np.int32),
                np.zeros((0, nnz_pad), np.float32),
                np.zeros(0, np.float32), 0)
    bounds = seg.postings.doc_starts.astype(np.int64)
    starts = bounds[doc_offs]
    lens = bounds[doc_offs + 1] - starts          # items incl. header
    # grouped arange: flat item indices of every selected doc's range
    out_starts = np.cumsum(lens) - lens
    total = int(lens.sum())
    flat = (np.arange(total, dtype=np.int64)
            - np.repeat(out_starts, lens) + np.repeat(starts, lens))
    sub = seg.stream()[flat]
    doc_ids, ids, vals, norms, _ = stream_format.decode_to_ell(
        sub, nnz_pad)
    n_trunc = int(np.maximum((lens - 1) - nnz_pad, 0).sum())
    return doc_ids, ids, vals, norms, n_trunc
