"""Fused decode + match + partial top-k: backend ``gpu_fused``, the port of
``repro.kernels.fused`` (DESIGN.md §12).

The paper's accelerator wins by fusion: the Fig. 8 stream is decoded,
matched and reduced to the high-score document ids in one pass. The
staged path runs decode (host) -> correlate (kernel) -> local_topk; this
one runs a single kernel (``csrc/fused.cu``) over the packed uint32 stream
itself, cut into fixed-capacity doc tiles by ``tile_stream`` (a host
boundary-index pass, not an ELL decode), and returns each tile's
``kp = min(k, block_docs)`` best candidates per query column.

Numerics: counts are 12-bit integers, so while score and norm partial
sums stay below 2**24 every accumulation order is exact in fp32 and the
result is bit-identical to the staged ``torch`` backend, including the
IEEE square root of the norms.

torch has no arithmetic on uint32: tile tensors carry the words as int32
with the same bits (``tiles.view(np.int32)``), so the pad word is -1.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.stream_format import (HEADER_BIT, KEY_BITS, KEY_MASK,
                                            MAX_DOC_ID, VAL_BITS, VAL_MASK)
from repro_torch.core.topk import rank_key
from repro_torch.kernels import _build
from repro_torch.kernels.sparse_match import (_check_query, on_cpu,
                                              run_sums, stream_of)

PAD_WORD = np.uint32(0xFFFFFFFF)
MAX_TILE_ROWS = 1024          # csrc/fused.cu: kMaxTileRows


class PackedSlab(NamedTuple):
    """A corpus slab in fused-kernel layout: the Fig. 8 stream split into
    fixed-capacity doc tiles, still packed (int32 view of the words)."""
    tiles: torch.Tensor       # [T, cap] int32 (PAD_WORD = -1 padding)


# ---------------------------------------------------------------------------
# host-side stream tiling (boundary index pass — NOT an ELL decode)
# ---------------------------------------------------------------------------
def tile_stream(stream: np.ndarray, *, block_docs: int, nnz_pad: int,
                pad_docs_to: Optional[int] = None
                ) -> Tuple[np.ndarray, int, int]:
    """Split a Fig. 8 uint32 stream into ``[T, cap]`` fixed-capacity doc
    tiles for the fused kernel. Applies the exact truncation rule of
    ``decode_to_ell`` (pairs beyond ``nnz_pad`` per document are
    dropped) so fused stats and scores match the staged path.

    ``pad_docs_to`` pads the tile count to ``ceil(pad_docs_to /
    block_docs)`` (all-PAD rows) so every segment of a store shares one
    launch shape — the fused analogue of ``Corpus.pad_docs_to``.

    Returns ``(tiles, n_docs, n_truncated)``.
    """
    stream = np.asarray(stream, np.uint32)
    cap = block_docs * (1 + nnz_pad)
    is_hdr = (stream & HEADER_BIT) != 0
    n_docs = int(is_hdr.sum())
    target = n_docs if pad_docs_to is None else int(pad_docs_to)
    if target < n_docs:
        raise ValueError(f"pad_docs_to {target} < n_docs {n_docs}")
    n_tiles = -(-target // block_docs) if target else 0
    if n_docs == 0:
        return np.full((n_tiles, cap), PAD_WORD, np.uint32), 0, 0
    if bool((stream == PAD_WORD).any()):
        # header word of doc_id MAX_DOC_ID collides with the pad
        # sentinel; the staged backends handle it, the fused one refuses
        raise ValueError(
            f"stream contains word 0x{int(PAD_WORD):08X} (doc_id "
            f"{MAX_DOC_ID}), which aliases the fused-kernel pad")
    # per-word document segment + within-document position
    hdr_pos = np.flatnonzero(is_hdr)
    seg = np.cumsum(is_hdr) - 1
    pos = np.arange(stream.size) - hdr_pos[seg]    # 0 = header, 1.. = pair
    keep = is_hdr | (pos <= nnz_pad)
    n_trunc = int(stream.size - int(keep.sum()))
    kept = stream[keep]
    # re-index the kept stream and scatter into (tile, column) slots
    is_hdr_k = (kept & HEADER_BIT) != 0
    hdr_pos_k = np.flatnonzero(is_hdr_k)
    doc_of = np.cumsum(is_hdr_k) - 1               # document per word
    tile_of = doc_of // block_docs
    tile_base = hdr_pos_k[tile_of * block_docs]    # tile's first word
    col = np.arange(kept.size) - tile_base
    tiles = np.full((n_tiles, cap), PAD_WORD, np.uint32)
    tiles[tile_of, col] = kept
    return tiles, n_docs, n_trunc


def corpus_to_stream(corpus) -> np.ndarray:
    """Re-encode an ELL ``Corpus`` (integral Fig. 8-representable
    counts) as the packed uint32 stream — the bridge for surfaces that
    only hold decoded rows (the resident engine corpus). Padding rows
    (doc_id < 0) are skipped; within-row pair order is preserved. Raises
    for values the 19/12-bit packing cannot carry."""
    ids = np.asarray(corpus.ids)
    vals = np.asarray(corpus.vals)
    doc_ids = np.asarray(corpus.doc_ids)
    rows = doc_ids >= 0
    valid = (ids >= 0) & rows[:, None]
    v = vals[valid]
    if v.size and (not np.all(v == np.round(v)) or v.min() < 0
                   or v.max() > VAL_MASK):
        raise ValueError(
            "fused/packed backends need integral counts in "
            f"[0, {VAL_MASK}] (Fig. 8 12-bit packing); use the torch or "
            "gpu backend for arbitrary float values")
    if ids[valid].size and int(ids[valid].max()) > KEY_MASK:
        raise ValueError(f"word id exceeds {KEY_BITS}-bit packing")
    if rows.any() and int(doc_ids[rows].max()) >= MAX_DOC_ID:
        raise ValueError(f"doc_id >= {MAX_DOC_ID} aliases the fused pad")
    lens = valid.sum(1)[rows]
    d_ids = doc_ids[rows].astype(np.uint32)
    starts = np.zeros(d_ids.size, np.int64)
    np.cumsum(lens[:-1] + 1, out=starts[1:])
    out = np.empty(int(lens.sum() + d_ids.size), np.uint32)
    out[starts] = HEADER_BIT | d_ids
    r, c = np.nonzero(valid[rows])
    rank = np.arange(r.size) - np.searchsorted(r, r)
    out[starts[r] + 1 + rank] = (
        (ids[rows][r, c].astype(np.uint32) << VAL_BITS)
        | vals[rows][r, c].astype(np.uint32))
    return out


# ---------------------------------------------------------------------------
# the fused kernel: plain version and wrapper
# ---------------------------------------------------------------------------
def fused_match_topk_plain(tiles: torch.Tensor, q_ids: torch.Tensor,
                           q_vals: torch.Tensor, q_norms: torch.Tensor, *,
                           block_docs: int, kp: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch, step for step: decode, per-row
    norms and doc ids, run-lookup match, cosine, per-tile top-kp."""
    T, cap = tiles.shape
    L = q_vals.shape[1]
    bd = block_docs
    dev = tiles.device
    w = tiles.view(torch.int32) if tiles.dtype == torch.uint32 else tiles
    is_pad = w == -1
    is_hdr = (w < 0) & ~is_pad                        # bit 31 set
    pair = ~is_pad & ~is_hdr
    row = torch.cumsum(is_hdr.to(torch.int32), dim=1) - 1
    in_tile = (row >= 0) & (row < bd)                 # rows past bd drop
    flat = torch.arange(T, device=dev)[:, None] * bd + row.clamp(0, bd - 1)
    keep = pair & in_tile
    seg = flat[keep]
    d_ids = ((w >> VAL_BITS) & KEY_MASK)[keep].to(torch.int32)
    d_vals = (w & VAL_MASK)[keep].float()
    sumsq = torch.zeros(T * bd, dtype=torch.float32, device=dev)
    sumsq.index_add_(0, seg, d_vals * d_vals)
    # float64 then float32: correctly rounded (torch's float32 sqrt on
    # the CPU is not always; the double rounding is harmless at 24 bits)
    dnorm = torch.sqrt(sumsq.double()).float()
    doc_id = torch.full((T * bd,), -1, dtype=torch.int32, device=dev)
    hdr = is_hdr & in_tile
    doc_id[flat[hdr]] = (w[hdr] & MAX_DOC_ID).to(torch.int32)
    corr = torch.zeros((T * bd, L), dtype=torch.float32, device=dev)
    corr.index_add_(0, seg, d_vals[:, None] * run_sums(d_ids, q_ids, q_vals))
    denom = dnorm[:, None] * q_norms[None, :]
    cos = torch.where(denom > 0, corr / torch.clamp(denom, min=1e-12),
                      -torch.inf)
    cos = torch.where(doc_id[:, None] >= 0, cos, -torch.inf)
    cos = cos.view(T, bd, L).transpose(1, 2)          # [T, L, bd]
    rank = torch.where(torch.isnan(cos), torch.inf, cos)
    _, idx = torch.sort(rank_key(rank), dim=-1, descending=True, stable=True)
    idx = idx[..., :kp]
    vals = torch.gather(cos, -1, idx)
    ids = doc_id.view(T, 1, bd).expand(T, L, bd).gather(-1, idx)
    return vals, torch.where(ids >= 0, ids, -1)


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])


def fused_match_topk(tiles: torch.Tensor, q_ids: torch.Tensor,
                     q_vals: torch.Tensor, q_norms: torch.Tensor, *,
                     block_docs: int, kp: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tiles [T, cap] packed words (int32 view, or uint32; cap =
    block_docs * (1 + nnz_pad)); q_ids [Qm] int32 merged stream (pads
    < 0); q_vals [Qm, L] float32; q_norms [L] float32. Returns per-tile
    candidates (vals [T, L, kp] float32, ids [T, L, kp] int32) — fold with
    ``core.topk.fold_topk``.

    CPU tensors run ``fused_match_topk_plain``; CUDA tensors launch the
    kernel (counted in ``fused_match_topk.launches``) or raise."""
    if tiles.dim() != 2:
        raise ValueError(f"tiles must be [T, cap], got {tuple(tiles.shape)}")
    if tiles.dtype == torch.uint32:
        tiles = tiles.view(torch.int32)
    if tiles.dtype != torch.int32:
        raise TypeError(f"tiles must be 32-bit words, got {tiles.dtype}")
    _check_query(q_ids, q_vals)
    T, cap = tiles.shape
    Qm, L = q_vals.shape
    if q_norms.shape != (L,) or q_norms.dtype != torch.float32:
        raise ValueError(f"q_norms must be float32 [{L}], got "
                         f"{q_norms.dtype} {tuple(q_norms.shape)}")
    if not 1 <= kp <= block_docs or cap % block_docs:
        raise ValueError(f"need 1 <= kp <= block_docs and block_docs | cap;"
                         f" got kp={kp} block_docs={block_docs} cap={cap}")
    if on_cpu(tiles, q_ids, q_vals, q_norms):
        return fused_match_topk_plain(tiles, q_ids, q_vals, q_norms,
                                      block_docs=block_docs, kp=kp)
    if block_docs > MAX_TILE_ROWS:
        raise ValueError(f"block_docs {block_docs} > {MAX_TILE_ROWS}")
    fn = _build.kernel("fused", "fused_match_topk_launch", _ARGTYPES)
    vals = torch.empty((T, L, kp), dtype=torch.float32, device=tiles.device)
    ids = torch.empty((T, L, kp), dtype=torch.int32, device=tiles.device)
    if vals.numel():
        _build.check("fused", fn(
            vals.device.index, tiles.data_ptr(), q_ids.data_ptr(),
            q_vals.data_ptr(), q_norms.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), T, cap, block_docs, Qm, L, kp, stream_of(vals)))
        _build.count_launch(fused_match_topk)
    return vals, ids


fused_match_topk.launches = 0


def stages(device, cap: int, block_docs: int, Qm: int, L: int) -> int:
    """Tile stages B3 takes for a launch on card ``device``:
    ``fused_match_topk_stages`` of ``csrc/fused.cu`` against the card's
    opt-in shared memory a block. 1: each doc tile is staged whole in
    shared memory; 0: tiles are read from device memory. Needs the card."""
    optin = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    fn = _build.kernel("fused", "fused_match_topk_stages",
                       [ctypes.c_int] * 4 + [ctypes.c_longlong])
    return fn(cap, block_docs, Qm, L, optin)
