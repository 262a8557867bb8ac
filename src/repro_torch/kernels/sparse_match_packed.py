"""Packed-format sparse match: backend ``gpu_packed``, the port of
``repro.kernels.sparse_match_packed``.

The corpus stays on the card in the paper's own Fig. 8 32-bit packing,
``[wordID:19 | count:12]`` with the top bit clear and 0xFFFFFFFF as the
pad, and is unpacked in the kernel by a shift and a mask: 4 B a slot
instead of ELL's 8 (``csrc/sparse_match_packed.cu``). The kernel looks
each word's id up in a hashed table of the query tile's distinct ids in
shared memory (``sparse_match.table_plan``); ids of 2^20 and above,
which no word carries, never match.

torch has no arithmetic on uint32, so the port's tensors carry packed
words as int32 with the same bits (``pack(...).view(np.int32)``); the
kernel reads them as uint32 and the pad word is -1.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sparse_match import (_check_query, card_tile_bytes,
                                              on_cpu, sparse_match_plain,
                                              stream_of)

VAL_BITS = 12
VAL_MASK = (1 << VAL_BITS) - 1
PAD_WORD = np.uint32(0xFFFFFFFF)


def pack(ids: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """ELL (ids int32 -1-padded, vals float32 integral counts) -> uint32."""
    ids = np.asarray(ids)
    vals = np.asarray(vals)
    counts = np.clip(vals, 0, VAL_MASK).astype(np.uint32)
    packed = (ids.astype(np.int64) << VAL_BITS).astype(np.uint32) | counts
    return np.where(ids < 0, PAD_WORD, packed)


def unpack(words: torch.Tensor):
    """int32-viewed packed words -> (ids int32, pad -1; vals float32)."""
    valid = words != -1
    ids = torch.where(valid, (words >> VAL_BITS) & 0xFFFFF, -1)
    vals = torch.where(valid, (words & VAL_MASK).float(), 0.0)
    return ids.to(torch.int32), vals


def sparse_match_packed_plain(docs_packed: torch.Tensor, q_ids: torch.Tensor,
                              q_vals: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch: unpack, then the ELL match."""
    ids, vals = unpack(docs_packed)
    return sparse_match_plain(ids, vals, q_ids, q_vals)


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])


def sparse_match_packed(docs_packed: torch.Tensor, q_ids: torch.Tensor,
                        q_vals: torch.Tensor) -> torch.Tensor:
    """docs_packed [D, K] packed words (int32 view, or uint32); q_ids [Qm]
    int32 (pad < 0); q_vals [Qm, L] float32 -> correlation [D, L].

    CPU tensors run ``sparse_match_packed_plain``; CUDA tensors launch
    the kernel (counted in ``sparse_match_packed.launches``) or raise."""
    if docs_packed.dim() != 2:
        raise ValueError(f"docs must be [D, K], got "
                         f"{tuple(docs_packed.shape)}")
    if docs_packed.dtype == torch.uint32:
        docs_packed = docs_packed.view(torch.int32)
    if docs_packed.dtype != torch.int32:
        raise TypeError(f"packed docs must be 32-bit words, got "
                        f"{docs_packed.dtype}")
    _check_query(q_ids, q_vals)
    if on_cpu(docs_packed, q_ids, q_vals):
        return sparse_match_packed_plain(docs_packed, q_ids, q_vals)
    fn = _build.kernel("sparse_match_packed", "sparse_match_packed_launch",
                       _ARGTYPES)
    D, K = docs_packed.shape
    Qm, L = q_vals.shape
    out = torch.empty((D, L), dtype=torch.float32,
                      device=docs_packed.device)
    if out.numel():
        _build.check("sparse_match_packed", fn(
            out.device.index, docs_packed.data_ptr(), q_ids.data_ptr(),
            q_vals.data_ptr(), out.data_ptr(), D, K, Qm, L, stream_of(out)))
        sparse_match_packed.launches += 1
    return out


sparse_match_packed.launches = 0


def tile_bytes(device, Qm: int, L: int) -> int:
    """B2's query tile on the card (``sparse_match.card_tile_bytes``), for
    ``sparse_match.query_tiles``'s report of its table."""
    return card_tile_bytes("sparse_match_packed", device, Qm, L)
