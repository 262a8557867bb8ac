"""MemTable — the searchable, not-yet-durable tail of a live store
(DESIGN.md §6.1).

Documents a writer has appended (and the WAL has logged) but no seal has
folded into a segment yet. It is a plain ordered list of ``(seq, doc)``
pairs; ``to_corpus`` round-trips through the Fig. 8 codec
(``encode`` → ``decode_to_ell``) so a memtable document is scored with
*exactly* the truncation and dtype behavior a segment-resident copy
would get — the bit-equivalence contract of the ingest tier rests on
that shared codec.

Mutations happen only under the ingest pipeline's state lock; snapshot
capture copies the (immutable-tuple) doc list, so a reader never
observes a half-applied append or seal.

A copy of ``repro.ingest.memtable``; its ELL build stays on the host, and
the plan executor uploads it with the query (``storage/plan.py``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import stream_format
from repro_torch.core.corpus import Corpus

Doc = Tuple[int, Sequence[Tuple[int, int]]]


class MemTable:
    def __init__(self):
        self._entries: List[Tuple[int, Doc]] = []

    def add(self, seq: int, doc: Doc):
        self._entries.append((seq, doc))

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def last_seq(self) -> int:
        return self._entries[-1][0] if self._entries else 0

    def docs(self) -> List[Doc]:
        """Copy of the documents in append order (tuples are immutable,
        so the copy is safe to use outside the state lock)."""
        return [d for _, d in self._entries]

    def clear_prefix(self, n: int):
        """Drop the ``n`` oldest entries (just sealed into a segment)."""
        del self._entries[:n]

    @staticmethod
    def docs_to_corpus(docs: Sequence[Doc],
                       nnz_pad: int) -> Tuple[Optional[Corpus], int]:
        """Docs -> (Corpus, pairs_truncated) via the segment codec, or
        (None, 0) when empty."""
        if not docs:
            return None, 0
        stream = stream_format.encode(docs)
        doc_ids, ids, vals, norms, n_trunc = stream_format.decode_to_ell(
            stream, nnz_pad)
        return Corpus(doc_ids, ids, vals, norms), n_trunc
