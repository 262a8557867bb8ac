"""Tiling strategies for the fused kernel (DESIGN.md §12.3).

A copy of ``repro.kernels.tiling`` without ``AutoTiling``, whose budget
is a TPU VMEM figure and waits to be derived from Hopper shared memory.

``doc_tile`` is chosen once per corpus scope (engine construction): it
fixes the packed-slab layout (``block_docs`` rows per tile), which is
part of the slab-cache key. ``query_tile`` is memoized per L bucket, so
one (Lp, Q-capacity) bucket still maps to exactly one launch key.

  - ``FixedTiling`` — always the config's ``block_docs``/``block_query``
    (the default, so fused and staged paths share shape families).
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class TileShape:
    """One resolved (doc, query) tile pair for a fused launch."""
    block_docs: int
    block_query: int


class TilingStrategy:
    """Base: ``doc_tile`` once per corpus, ``query_tile`` per L bucket.

    Subclasses implement ``_doc_tile`` / ``_query_tile``; the base class
    owns the per-bucket memo table (``bucket_shapes`` exposes it)."""

    def __init__(self):
        self._bucket_memo: Dict[int, int] = {}

    # -- corpus-scope choice (fixed for the engine's lifetime) ---------
    def doc_tile(self, *, nnz_pad: int, n_docs: int) -> int:
        bd = int(self._doc_tile(nnz_pad=nnz_pad, n_docs=max(n_docs, 1)))
        if bd < 1:
            raise ValueError(f"doc_tile must be >= 1, got {bd}")
        return bd

    # -- bucket-scope choice (memoized: one shape per L bucket) --------
    def query_tile(self, Lp: int) -> int:
        tq = self._bucket_memo.get(Lp)
        if tq is None:
            tq = int(self._query_tile(Lp=max(Lp, 1)))
            if tq < 1:
                raise ValueError(f"query_tile must be >= 1, got {tq}")
            self._bucket_memo[Lp] = tq
        return tq

    @property
    def bucket_shapes(self) -> Dict[int, int]:
        """L bucket -> chosen query tile, for every bucket seen so far."""
        return dict(self._bucket_memo)

    def _doc_tile(self, *, nnz_pad: int, n_docs: int) -> int:
        raise NotImplementedError

    def _query_tile(self, *, Lp: int) -> int:
        raise NotImplementedError


class FixedTiling(TilingStrategy):
    """The config's static shapes, for every density and bucket."""

    def __init__(self, block_docs: int, block_query: int):
        super().__init__()
        if block_docs < 1 or block_query < 1:
            raise ValueError("tile sides must be >= 1")
        self.block_docs = int(block_docs)
        self.block_query = int(block_query)

    def _doc_tile(self, *, nnz_pad: int, n_docs: int) -> int:
        return self.block_docs

    def _query_tile(self, *, Lp: int) -> int:
        return self.block_query
