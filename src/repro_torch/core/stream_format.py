"""The paper's 32-bit stream encoding (Fig. 8).

Each 32-bit item is either a pattern (document) identifier or a key/value
pair. We use bit 31 as the header flag:

    header:  [1 | docID (31 bits)]
    pair:    [0 | wordID (19 bits) | count (12 bits, saturating)]

19 bits of wordID covers the paper's 141k-word vocabulary (and up to 512k);
12-bit counts saturate at 4095 (word frequencies beyond that carry no
cosine-relevant information at these sparsities). A document is one header
followed by its (sorted) key/value pairs — the paper measured ~50% storage-
bandwidth savings over the UCI one-tuple-per-line format, which we verify in
tests/test_stream_format.py.

The numpy codec is the host/storage data plane; ``decode_to_ell`` is the
ingest ("flash interface logic" analogue) producing the engine's ELL rows.
A copy of ``repro.core.stream_format``: both packages read and write the
same bytes (tests/test_torch_formats.py holds them to it).
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

HEADER_BIT = np.uint32(1 << 31)
KEY_BITS = 19
VAL_BITS = 12
KEY_MASK = (1 << KEY_BITS) - 1
VAL_MASK = (1 << VAL_BITS) - 1
MAX_DOC_ID = (1 << 31) - 1


def encode(docs: Sequence[Tuple[int, Sequence[Tuple[int, int]]]]) -> np.ndarray:
    """docs: [(doc_id, [(word_id, count), ...]), ...] -> uint32 stream.
    Pairs are sorted by word_id (the paper streams sorted keys)."""
    out: List[np.ndarray] = []
    for doc_id, pairs in docs:
        if not 0 <= doc_id <= MAX_DOC_ID:
            raise ValueError(f"doc_id {doc_id} out of range")
        arr = np.empty(len(pairs) + 1, np.uint32)
        arr[0] = HEADER_BIT | np.uint32(doc_id)
        sp = sorted(pairs)
        for i, (w, c) in enumerate(sp):
            if not 0 <= w <= KEY_MASK:
                raise ValueError(f"word_id {w} out of range")
            arr[i + 1] = (np.uint32(w) << VAL_BITS) | np.uint32(min(c, VAL_MASK))
        out.append(arr)
    return np.concatenate(out) if out else np.empty(0, np.uint32)


def encode_rows(doc_ids: np.ndarray, ids: np.ndarray,
                vals: np.ndarray) -> np.ndarray:
    """ELL rows -> uint32 stream, vectorized: the bytes ``encode`` gives
    for each row with ``doc_id >= 0`` as ``(doc_id, [(id, int(val)) for
    its slots with id >= 0])``. Pairs sort by (word, count) and counts
    saturate at ``VAL_MASK``, as there; a negative count, word id or
    doc id out of range raises ``ValueError``."""
    doc_ids = np.asarray(doc_ids, np.int64)
    rows = doc_ids >= 0
    doc_ids = doc_ids[rows]
    ids = np.asarray(ids)[rows]
    vals = np.asarray(vals)[rows]
    if doc_ids.size and int(doc_ids.max()) > MAX_DOC_ID:
        raise ValueError(f"doc_id {int(doc_ids.max())} out of range")
    valid = ids >= 0
    r, c = np.nonzero(valid)
    words = ids[r, c].astype(np.int64)
    counts = vals[r, c].astype(np.int64)       # int(val): toward zero
    if words.size and int(words.max()) > KEY_MASK:
        raise ValueError(f"word_id {int(words.max())} out of range")
    if counts.size and int(counts.min()) < 0:
        raise ValueError(f"count {int(counts.min())} is negative")
    # one int64 key a pair: row, then the pair's own item (word, then
    # saturated count; counts above VAL_MASK saturate alike either way)
    key = np.sort((r.astype(np.int64) << 31) | (words << VAL_BITS)
                  | np.minimum(counts, VAL_MASK))
    r = key >> 31
    lens = valid.sum(1)
    starts = np.zeros(doc_ids.size, np.int64)
    np.cumsum(lens[:-1] + 1, out=starts[1:])
    out = np.empty(int(lens.sum()) + doc_ids.size, np.uint32)
    out[starts] = HEADER_BIT | doc_ids.astype(np.uint32)
    # the i-th pair in row order sits after the headers of rows 0..r
    out[np.arange(r.size) + r + 1] = (key & 0x7FFFFFFF).astype(np.uint32)
    return out


def decode(stream: np.ndarray):
    """uint32 stream -> [(doc_id, [(word_id, count), ...]), ...]."""
    stream = np.asarray(stream, np.uint32)
    is_hdr = (stream & HEADER_BIT) != 0
    docs = []
    cur = None
    for item, hdr in zip(stream.tolist(), is_hdr.tolist()):
        if hdr:
            cur = (item & MAX_DOC_ID, [])
            docs.append(cur)
        else:
            if cur is None:
                raise ValueError("pair before any header")
            cur[1].append(((item >> VAL_BITS) & KEY_MASK, item & VAL_MASK))
    return docs


def decode_to_ell(stream: np.ndarray, nnz_pad: int):
    """Vectorized stream -> ELL tiles (ids padded with -1, float32 values,
    fp32 L2 norms) plus the number of pairs dropped because their document
    exceeded ``nnz_pad``. This is the ingest path the engine uses; callers
    that care about exactness must check ``n_truncated == 0``.

    Returns ``(doc_ids, ids, vals, norms, n_truncated)``.
    """
    stream = np.asarray(stream, np.uint32)
    is_hdr = (stream & HEADER_BIT) != 0
    n_docs = int(is_hdr.sum())
    if n_docs == 0:
        return (np.empty((0,), np.int64), np.full((0, nnz_pad), -1, np.int32),
                np.zeros((0, nnz_pad), np.float32), np.zeros((0,), np.float32),
                0)
    hdr_pos = np.flatnonzero(is_hdr)
    doc_ids = (stream[hdr_pos] & MAX_DOC_ID).astype(np.int64)
    # for every item, which document segment it belongs to
    seg = np.cumsum(is_hdr) - 1
    pair_mask = ~is_hdr
    pair_seg = seg[pair_mask]
    words = ((stream[pair_mask] >> VAL_BITS) & KEY_MASK).astype(np.int32)
    counts = (stream[pair_mask] & VAL_MASK).astype(np.float32)
    # position of each pair within its document
    idx = np.arange(stream.size)[pair_mask]
    pos = idx - hdr_pos[pair_seg] - 1
    keep = pos < nnz_pad  # truncate docs longer than the pad
    n_truncated = int((~keep).sum())
    ids = np.full((n_docs, nnz_pad), -1, np.int32)
    vals = np.zeros((n_docs, nnz_pad), np.float32)
    ids[pair_seg[keep], pos[keep]] = words[keep]
    vals[pair_seg[keep], pos[keep]] = counts[keep]
    norms = np.sqrt((vals.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    return doc_ids, ids, vals, norms, n_truncated


def stream_bytes(docs) -> int:
    """Size of the Fig. 8 encoding."""
    return sum(4 * (1 + len(p)) for _, p in docs)


def uci_bytes(docs) -> int:
    """Size of the UCI-style (docID, wordID, count) per-line binary format
    the paper compares against (8 bytes/tuple with 32-bit docID+packed
    word/count — we charge 2 items of 4B per tuple)."""
    return sum(8 * len(p) for _, p in docs)
