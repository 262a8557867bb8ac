"""On-disk segment files for the flash tier (DESIGN.md §3.1).

A segment is the unit a flash slice serves: the Fig. 8 uint32 stream
(``core/stream_format``) laid out in fixed-size pages, each page starting
at a document header so it decodes independently, followed by the
segment's vocabulary filter and a footer index:

    [magic "RSPSEG1\\n"]
    [page 0 | page 1 | ...]          raw uint32 stream, doc-aligned splits
    [filter bytes]                   BitmapFilter / BloomFilter payload
    [postings bytes]                 PostingIndex payload (approx tier)
    [footer JSON]                    page index + doc-id range + filter meta
    [footer offset u64 LE][magic "RSPSEGF\\n"]

The footer carries, per page: byte offset, item count, doc count and the
min/max doc id — enough for point lookups and range pruning without
touching page data. Readers memory-map the file; ``stream()`` is a
zero-copy uint32 view over all pages, so decode cost is paid only for
segments that survive the vocabulary filter.

A copy of ``repro.storage.segment``: both packages write the same bytes
for the same documents and read each other's files. ``stream()`` views
the read-only mmap; ``torch.from_numpy`` on it would warn and alias the
file, so device uploads go through a decode or a tiling copy first
(``storage/plan.py``). ``write_stream_segment`` takes an already encoded
stream (the store's vectorized ``append_corpus``); ``write_segment``
encodes documents first, as the reference does.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import stream_format
from repro_torch.storage import filter as filter_lib
from repro_torch.storage import postings as postings_lib

MAGIC = b"RSPSEG1\n"
FOOTER_MAGIC = b"RSPSEGF\n"
VERSION = 1
DEFAULT_PAGE_ITEMS = 1 << 15   # 128 KB pages of 4-byte items


def _page_splits(stream: np.ndarray, hdr_pos: np.ndarray,
                 page_items: int) -> List[Tuple[int, int]]:
    """Split the stream at document headers into [start, end) item ranges
    of at most ``page_items`` items (a single over-long document gets its
    own over-sized page rather than being torn). ``hdr_pos`` is the item
    index of every document header."""
    if hdr_pos.size == 0:
        return []
    if int(hdr_pos[0]) != 0:
        raise ValueError("stream must begin with a document header")
    # doc i occupies items [bounds[i], bounds[i+1])
    bounds = np.append(hdr_pos, stream.size)
    splits = []
    i, n = 0, hdr_pos.size
    while i < n:
        j = i + 1   # page always takes doc i, even if it alone overflows
        while j < n and int(bounds[j + 1] - bounds[i]) <= page_items:
            j += 1
        splits.append((int(bounds[i]), int(bounds[j])))
        i = j
    return splits


def write_segment(path: str, docs: Sequence[Tuple[int, Sequence[Tuple[int, int]]]],
                  *, page_items: int = DEFAULT_PAGE_ITEMS,
                  vocab_size: Optional[int] = None,
                  filter_kind: str = "auto", fsync: bool = False) -> Dict:
    """Encode ``docs`` ([(doc_id, [(word, count), ...])]) into a segment
    file at ``path``. Returns the footer dict (the manifest keeps a
    subset). Writes to ``path + '.tmp'`` and atomically renames.
    ``fsync=True`` flushes the data to disk before the rename — required
    when a durable manifest will reference this file (a manifest that
    survives power loss must never point at torn pages)."""
    return write_stream_segment(
        path, stream_format.encode(docs), page_items=page_items,
        vocab_size=vocab_size, filter_kind=filter_kind, fsync=fsync)


def write_stream_segment(path: str, stream: np.ndarray, *,
                         page_items: int = DEFAULT_PAGE_ITEMS,
                         vocab_size: Optional[int] = None,
                         filter_kind: str = "auto",
                         fsync: bool = False) -> Dict:
    """``write_segment`` for a Fig. 8 stream that is already encoded
    (``stream_format.encode``'s output, or ``encode_rows``'): the same
    file, byte for byte."""
    stream = np.asarray(stream, np.uint32)
    hdr_pos = np.flatnonzero((stream & stream_format.HEADER_BIT) != 0)
    splits = _page_splits(stream, hdr_pos, page_items)
    # word ids come straight off the encoded stream (encode() already
    # validated every id): all non-header items, keyed per Fig. 8
    pair_items = stream[(stream & stream_format.HEADER_BIT) == 0]
    word_ids = ((pair_items >> stream_format.VAL_BITS)
                & stream_format.KEY_MASK).astype(np.int64)
    filt = filter_lib.build_filter(word_ids, vocab_size=vocab_size,
                                   kind=filter_kind)
    filter_raw = filt.to_bytes()
    postings = postings_lib.PostingIndex.build(stream)
    postings_raw = postings.to_bytes()

    doc_ids = (stream[hdr_pos] & stream_format.MAX_DOC_ID).astype(np.int64)
    pages = []
    data_off = len(MAGIC)
    for start, end in splits:
        lo = int(np.searchsorted(hdr_pos, start, side="left"))
        hi = int(np.searchsorted(hdr_pos, end, side="left"))
        page_docs = doc_ids[lo:hi]
        pages.append({
            "off": data_off + 4 * start,
            "n_items": end - start,
            "n_docs": int(hi - lo),
            "doc_min": int(page_docs.min()) if page_docs.size else -1,
            "doc_max": int(page_docs.max()) if page_docs.size else -1,
        })

    filter_off = data_off + 4 * stream.size
    postings_off = filter_off + len(filter_raw)
    footer = {
        "version": VERSION,
        "n_docs": int(doc_ids.size),
        "n_items": int(stream.size),
        "doc_id_min": int(doc_ids.min()) if doc_ids.size else -1,
        "doc_id_max": int(doc_ids.max()) if doc_ids.size else -1,
        "data_off": data_off,
        "pages": pages,
        "filter": {"off": filter_off, "nbytes": len(filter_raw),
                   "meta": filt.meta()},
        "postings": {"off": postings_off, "nbytes": len(postings_raw),
                     "meta": postings.meta()},
    }
    footer_raw = json.dumps(footer).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(stream.astype("<u4").tobytes())
        f.write(filter_raw)
        f.write(postings_raw)
        footer_off = f.tell()
        f.write(footer_raw)
        f.write(struct.pack("<Q", footer_off))
        f.write(FOOTER_MAGIC)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    return footer


def read_footer(path: str) -> Dict:
    """Read a segment's footer JSON with plain seeks — no mmap, no page
    data touched. This is the cheap path store-wide stats and rebalance
    planning use to inspect cold segments."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        tail = 8 + len(FOOTER_MAGIC)
        if size < len(MAGIC) + tail:
            raise ValueError(f"{path}: too small to be a segment file")
        f.seek(size - tail)
        trailer = f.read(tail)
        if trailer[8:] != FOOTER_MAGIC:
            raise ValueError(f"{path}: bad footer magic (truncated write?)")
        (footer_off,) = struct.unpack("<Q", trailer[:8])
        if not len(MAGIC) <= footer_off <= size - tail:
            raise ValueError(f"{path}: footer offset {footer_off} out of range")
        f.seek(footer_off)
        return json.loads(f.read(size - tail - footer_off))


class Segment:
    """Memory-mapped reader over one segment file."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[:len(MAGIC)] != MAGIC:
            raise ValueError(f"{path}: bad segment magic")
        if self._mm[-len(FOOTER_MAGIC):] != FOOTER_MAGIC:
            raise ValueError(f"{path}: bad footer magic (truncated write?)")
        (footer_off,) = struct.unpack(
            "<Q", self._mm[-len(FOOTER_MAGIC) - 8:-len(FOOTER_MAGIC)])
        self.footer = json.loads(
            self._mm[footer_off:len(self._mm) - len(FOOTER_MAGIC) - 8])
        if self.footer["version"] != VERSION:
            raise ValueError(f"{path}: unsupported version")
        self._filter = None
        self._postings = None

    # -- metadata ------------------------------------------------------
    @property
    def n_docs(self) -> int:
        return self.footer["n_docs"]

    @property
    def n_items(self) -> int:
        return self.footer["n_items"]

    @property
    def doc_id_range(self) -> Tuple[int, int]:
        return self.footer["doc_id_min"], self.footer["doc_id_max"]

    @property
    def nbytes(self) -> int:
        return len(self._mm)

    # -- data plane ----------------------------------------------------
    def stream(self) -> np.ndarray:
        """Zero-copy uint32 view over the full Fig. 8 stream."""
        off = self.footer["data_off"]
        return np.frombuffer(self._mm, dtype="<u4", count=self.n_items,
                             offset=off)

    def page_stream(self, i: int) -> np.ndarray:
        p = self.footer["pages"][i]
        return np.frombuffer(self._mm, dtype="<u4", count=p["n_items"],
                             offset=p["off"])

    @property
    def n_pages(self) -> int:
        return len(self.footer["pages"])

    # -- filter --------------------------------------------------------
    @property
    def vocab_filter(self):
        if self._filter is None:
            meta = self.footer["filter"]
            raw = self._mm[meta["off"]:meta["off"] + meta["nbytes"]]
            self._filter = filter_lib.from_meta(meta["meta"], raw)
        return self._filter

    @property
    def postings(self):
        """Lazy posting index, or None for pre-postings segment files
        (the planner then keeps those segments on the exact path)."""
        if self._postings is None:
            meta = self.footer.get("postings")
            if meta is None:
                return None
            raw = self._mm[meta["off"]:meta["off"] + meta["nbytes"]]
            self._postings = postings_lib.PostingIndex.from_bytes(
                meta["meta"], raw)
        return self._postings

    def docs(self):
        """Decode back to [(doc_id, [(word, count), ...])] (compaction /
        debugging path; the query path uses decode_to_ell on stream())."""
        return stream_format.decode(self.stream())

    def close(self):
        if self._mm is not None:
            self._mm.close()
            self._file.close()
            self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
