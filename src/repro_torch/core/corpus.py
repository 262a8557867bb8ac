"""Corpus construction: the paper's synthesizer, Fig. 8 stream ingest and
self-search queries. A copy of the parts of ``repro.core.corpus`` the
resident engine needs, so one seed gives one corpus in both packages.

A corpus is held in ELL form (DESIGN.md §2): ``ids [n_docs, K]`` int32
(-1 padding), ``vals [n_docs, K]`` float32, ``doc_ids [n_docs]``,
``norms [n_docs]``. It stays on the host; the engine uploads it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import stream_format


@dataclasses.dataclass
class Corpus:
    doc_ids: np.ndarray   # [n] int64
    ids: np.ndarray       # [n, K] int32, -1 padded, sorted per row
    vals: np.ndarray      # [n, K] float32
    norms: np.ndarray     # [n] float32

    @property
    def n_docs(self) -> int:
        return self.ids.shape[0]

    @property
    def nnz_pad(self) -> int:
        return self.ids.shape[1]

    @classmethod
    def empty(cls, nnz_pad: int) -> "Corpus":
        return cls(np.empty(0, np.int64),
                   np.full((0, nnz_pad), -1, np.int32),
                   np.zeros((0, nnz_pad), np.float32),
                   np.zeros(0, np.float32))

    def slice_rows(self, lo: int, hi: int) -> "Corpus":
        return Corpus(self.doc_ids[lo:hi], self.ids[lo:hi],
                      self.vals[lo:hi], self.norms[lo:hi])

    def pad_docs_to(self, n: int) -> "Corpus":
        """Pad with empty documents (id -1) up to ``n`` rows."""
        extra = n - self.n_docs
        if extra <= 0:
            return self
        K = self.nnz_pad
        return Corpus(
            np.concatenate([self.doc_ids, np.full(extra, -1, np.int64)]),
            np.concatenate([self.ids, np.full((extra, K), -1, np.int32)]),
            np.concatenate([self.vals, np.zeros((extra, K), np.float32)]),
            np.concatenate([self.norms, np.zeros(extra, np.float32)]),
        )


def from_stream(stream: np.ndarray, nnz_pad: int, *,
                strict: bool = False) -> Corpus:
    """Fig. 8 uint32 stream -> Corpus. ``strict`` raises if any document
    had pairs truncated to fit ``nnz_pad`` (decode_to_ell reports the
    count; silent truncation changes scores)."""
    doc_ids, ids, vals, norms, n_trunc = stream_format.decode_to_ell(
        stream, nnz_pad)
    if strict and n_trunc:
        raise ValueError(
            f"{n_trunc} pairs truncated decoding stream at nnz_pad={nnz_pad}")
    return Corpus(doc_ids, ids, vals, norms)


def synthesize(n_docs: int, vocab_size: int, avg_nnz: int, nnz_pad: int,
               seed: int = 0, zipf: float = 1.1) -> Corpus:
    """The paper's dataset synthesizer (§IV.A): generate documents as
    permutations of word sets with random add/remove and random counts.
    Word frequencies follow a Zipf-ish distribution like real text."""
    rng = np.random.default_rng(seed)
    n_base = max(1, n_docs // 16)
    lens = np.clip(rng.poisson(avg_nnz, n_docs), 1, nnz_pad).astype(np.int64)
    ids = np.full((n_docs, nnz_pad), -1, np.int32)
    vals = np.zeros((n_docs, nnz_pad), np.float32)
    # base "topics": each a word set; documents permute a base set
    ranks = rng.zipf(zipf, size=(n_base, nnz_pad * 2)) % vocab_size
    for i in range(n_docs):
        base = ranks[rng.integers(n_base)]
        take = lens[i]
        words = rng.choice(base, take, replace=False) if take <= base.size \
            else base
        # random add/remove (the paper's permutation step)
        n_mut = max(1, take // 8)
        words[:n_mut] = rng.integers(0, vocab_size, n_mut)
        words = np.unique(words.astype(np.int32))
        k = words.size
        ids[i, :k] = np.sort(words)
        vals[i, :k] = rng.integers(1, 30, k).astype(np.float32)
    norms = np.sqrt((vals ** 2).sum(1)).astype(np.float32)
    return Corpus(np.arange(n_docs, dtype=np.int64), ids, vals, norms)


def make_query(corpus: Corpus, doc_index: int, max_nnz: int):
    """Query = an existing document (self-search must return itself)."""
    ids = corpus.ids[doc_index]
    vals = corpus.vals[doc_index]
    keep = ids >= 0
    q_ids = np.full(max_nnz, -1, np.int32)
    q_vals = np.zeros(max_nnz, np.float32)
    k = min(int(keep.sum()), max_nnz)
    q_ids[:k] = ids[keep][:k]
    q_vals[:k] = vals[keep][:k]
    return q_ids, q_vals
