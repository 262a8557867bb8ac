"""The least time a scoring pass could take, whatever implements it.

One batch of L queries against the corpus needs at least:

- bytes: the corpus once, counted as the paper's Fig. 8 words (4 B a
  real (word, count) pair and 4 B a document header: the on-flash
  format, not ELL's padded rows or a tile's capacity); the merged query
  stream (4 B an id and 4 B for each of its Lp value columns, Lp the
  L bucket); the [L, k] ids and scores written out (8 B an entry);
- operations: 2 a (corpus pair, query column) product that the batch's
  queries match, counted from the inputs: a query word w matches the
  ``df[w]`` pairs that carry it.

Its least time is the larger of bytes over peak bandwidth and operations
over peak float32 rate outside the tensor cores. The counting reads the
harness's corpus, in either of its layouts, and never the program.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM3 bandwidth; float32 on the CUDA cores
PEAKS = {"H100": {"bytes_per_s": 3.35e12, "flop_per_s": 67e12}}


def peaks(device_name: str) -> Optional[dict]:
    for key, pk in PEAKS.items():
        if key in device_name:
            return pk
    return None


def counts_from_ell(ids: torch.Tensor, vocab_size: int):
    """(documents, real pairs, [vocab] pairs a word) of ELL rows."""
    real = ids[ids >= 0].to(torch.int64)
    return (ids.shape[0], real.numel(),
            torch.bincount(real, minlength=vocab_size).cpu().numpy())


def counts_from_tiles(tiles: torch.Tensor, vocab_size: int):
    """The same counts read from Fig. 8 doc tiles (int32 words, -1 pad)."""
    w = tiles.reshape(-1)
    hdr = (w < 0) & (w != -1)
    pair = w >= 0
    words = (w[pair] >> 12).to(torch.int64)
    return (int(hdr.sum()), words.numel(),
            torch.bincount(words, minlength=vocab_size).cpu().numpy())


def corpus_bytes(n_docs: int, n_pairs: int) -> int:
    return 4 * (n_docs + n_pairs)


def bucket(L: int) -> int:
    return 1 << max(L - 1, 0).bit_length()


def batch_work(q_ids: np.ndarray, df: np.ndarray, top_k: int,
               corpus_nbytes: int):
    """(bytes, operations) of one pass of the [L, Qn] batch (pad < 0)."""
    L = q_ids.shape[0]
    words = q_ids[q_ids >= 0].astype(np.int64)
    nbytes = (corpus_nbytes + 4 * words.size * (1 + bucket(L))
              + 8 * L * top_k)
    return nbytes, 2 * int(df[words].sum())


def least_seconds(nbytes: float, flops: float, pk: dict) -> float:
    return max(nbytes / pk["bytes_per_s"], flops / pk["flop_per_s"])
