"""Tiling strategies for the fused kernel (DESIGN.md §12.3).

A copy of ``repro.kernels.tiling``. ``AutoTiling`` chooses as the
reference does, given the same budget; its default budget is derived
from the H100's shared memory instead of a TPU core's VMEM (see
``DEFAULT_SMEM_BUDGET``).

``doc_tile`` is chosen once per corpus scope (engine construction): it
fixes the packed-slab layout (``block_docs`` rows per tile), which is
part of the slab-cache key. ``query_tile`` is memoized per L bucket, so
one (Lp, Q-capacity) bucket still maps to exactly one launch key.

  - ``FixedTiling`` — always the config's ``block_docs``/``block_query``
    (the default, so fused and staged paths share shape families);
  - ``AutoTiling`` — fits the doc tile to a shared-memory budget,
    narrower for denser corpora, in power-of-two steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# B3 (``csrc/fused.cu``) stages each doc tile whole in shared memory when
# its block fits the card's opt-in, 227 KB (232 448 bytes) a block on the
# H100 (228 KB an SM). A block holds (``fused_layout``): the tile's stage,
# 4 * (block_docs * (1 + nnz_pad) + 3) bytes; the correlation scratch,
# 4 * block_docs * 8 at L >= 8; the query tile with its table, at most
# 16 + 32 768 + 32 768 bytes (8192 items, ``query_tile_smem``); the row
# arrays, 12 bytes a row + 4 (at most 12 292 at 1024 rows, its cap); the
# barrier and counters, 80 bytes; each part rounded up to 16.
# ``AutoTiling`` gives the stage and the scratch at ref_L = 8 half its
# budget. With 192 KiB that half is 96 KiB, and the whole block is at
# most 98 304 + 65 552 + 12 292 + 80 + 12 + 5 * 15 = 176 315 bytes, under
# 232 448: every tile it picks is staged (``fused_match_topk_stages`` is
# 1) at any nnz_pad. At nnz_pad 128 the half gives 128 rows, the tile of
# the config's default (66 064 bytes, two blocks an SM at the main
# shape); at nnz_pad 64, 256 and 512 it gives 256, 64 and 32 rows, and
# the config's block_docs caps each (128 by default).
DEFAULT_SMEM_BUDGET = 192 * 1024   # bytes


def _pow2_floor(n: int) -> int:
    return 1 << max(int(n).bit_length() - 1, 0)


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


class AutoTiling(TilingStrategy):
    """Budget-driven shapes, the reference's rule. Doc side: the largest
    power-of-two tile whose packed words + correlation scratch (at the
    reference L) fit half the budget — dense corpora (large nnz_pad) get
    narrower tiles. Query side: the largest power-of-two divisor of
    ``block_query`` whose id+value tile fits the other half at the
    bucket's L. In the port the query tile only pads the merged stream
    (``ops.fused_topk``): B3 builds its own query tile of up to 8192
    items, which the budget's derivation above sets aside.

    Both sides clamp to the config's static shapes as upper bounds, so
    AutoTiling only ever *shrinks* tiles — the merged-stream capacity
    (a multiple of ``block_query``) stays divisible by every choice.
    """

    def __init__(self, block_docs: int, block_query: int, *,
                 smem_budget: int = DEFAULT_SMEM_BUDGET, ref_L: int = 8):
        super().__init__()
        if block_docs < 1 or block_query < 1:
            raise ValueError("tile sides must be >= 1")
        if smem_budget < 4096:
            raise ValueError("smem_budget unrealistically small")
        self.block_docs = int(block_docs)
        self.block_query = int(block_query)
        self.smem_budget = int(smem_budget)
        self.ref_L = int(ref_L)

    def _doc_tile(self, *, nnz_pad: int, n_docs: int) -> int:
        # per doc row: (1 + nnz_pad) packed words + ref_L fp32 scratch
        row_bytes = 4 * (1 + nnz_pad + self.ref_L)
        fit = _pow2_floor(max((self.smem_budget // 2) // row_bytes, 1))
        return max(min(fit, self.block_docs, _pow2_floor(n_docs) * 2), 8)

    def _query_tile(self, *, Lp: int) -> int:
        # per query item: one id word + Lp fp32 value columns
        item_bytes = 4 * (1 + Lp)
        fit = _pow2_floor(max((self.smem_budget // 2) // item_bytes, 1))
        tq = self.block_query
        while tq >= 16 and tq > fit:
            tq //= 2          # power-of-two descent: tq | block_query,
        return tq             # floored so it never halves below 8
