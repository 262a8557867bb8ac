"""Public wrappers around the sparse-match kernel family, the port of
``repro.kernels.ops``.

Handles padding to tile multiples, merged multi-query streams, sentinel
conventions and cosine normalization. ``backend``:
  - "gpu": the ELL kernel (``sparse_match``), the default
  - "gpu_packed": the Fig. 8 packed-word kernel (int32-viewed words)
  - "gpu_fused": decode+match+top-k in one kernel over packed doc tiles,
    wrapped by ``fused_topk``, which returns folded [L, k] winners
    instead of a correlation matrix
  - "torch": the gather path (``kernels.ref``), only when asked for
On CPU tensors each kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.topk import fold_topk
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels.fused import fused_match_topk
from repro_torch.kernels.sparse_match import QUERY_PAD, sparse_match
from repro_torch.kernels.sparse_match_packed import sparse_match_packed

BACKENDS = ("gpu", "gpu_packed", "gpu_fused", "torch")


def _pad_to(x: torch.Tensor, n: int, axis: int, fill) -> torch.Tensor:
    need = n - x.shape[axis]
    if need <= 0:
        return x
    pads = [0, 0] * x.dim()
    pads[2 * (x.dim() - 1 - axis) + 1] = need      # F.pad: last axis first
    return F.pad(x, pads, value=fill)


def merge_queries(q_ids: np.ndarray, q_vals: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack L queries ([L, Qn] ids, [L, Qn] vals, pad<0) into one merged
    id stream with L value columns: ids [Qm], vals [Qm, L].

    Rows with zero non-pad terms simply contribute no items (their value
    column stays all-zero, so they score 0 against everything), and an
    empty batch (L = 0, or every row empty) yields the well-defined
    zero-length stream — not a concatenate error."""
    L_, _ = q_ids.shape
    if L_ == 0:
        return np.empty(0, np.int32), np.zeros((0, 0), np.float32)
    ids_out, vals_out = [], []
    for l in range(L_):
        keep = q_ids[l] >= 0
        ids_out.append(q_ids[l][keep])
        v = np.zeros((keep.sum(), L_), np.float32)
        v[:, l] = q_vals[l][keep]
        vals_out.append(v)
    ids = np.concatenate(ids_out).astype(np.int32)
    vals = np.concatenate(vals_out, axis=0)
    order = np.argsort(ids, kind="stable")
    return ids[order], vals[order]


def correlate(doc_ids: torch.Tensor, doc_vals: torch.Tensor,
              q_ids: torch.Tensor, q_vals: torch.Tensor, *,
              backend: str = "gpu", vocab_size: int = 0,
              block_docs: int = 128, block_query: int = 512
              ) -> torch.Tensor:
    """Correlation (cosine numerator) [D, L]. For ``gpu_packed``,
    ``doc_ids`` holds the packed words and ``doc_vals`` is unused."""
    D = doc_ids.shape[0]
    L_ = q_vals.shape[1]
    if backend not in ("gpu", "gpu_packed", "torch"):
        raise ValueError(f"correlate backend must be 'gpu', 'gpu_packed' "
                         f"or 'torch', got {backend!r}")
    if D == 0 or L_ == 0:
        # degenerate shapes (empty corpus / empty batch): the
        # well-defined zero correlation, not an empty-grid launch
        return torch.zeros((D, L_), dtype=torch.float32,
                           device=doc_ids.device)
    if backend == "torch":
        if vocab_size <= 0:
            raise ValueError("torch backend needs vocab_size")
        qi = torch.where(q_ids < 0, -1, q_ids)
        return ref_mod.sparse_match_ref(doc_ids, doc_vals, qi, q_vals,
                                        vocab_size)
    Qm = q_ids.shape[0]
    td = min(block_docs, max(D, 8))
    tq = min(block_query, max(Qm, 8))
    Dp = -(-D // td) * td
    # a zero-length merged stream still pads to one full query tile: the
    # kernel then scores all-pad items to the all-zero row
    Qp = max(-(-Qm // tq) * tq, tq)
    qi = _pad_to(q_ids, Qp, 0, QUERY_PAD)
    qv = _pad_to(q_vals, Qp, 0, 0.0)
    # query padding might collide with doc padding sentinel: remap
    qi = torch.where(qi < 0, QUERY_PAD, qi).contiguous()
    qv = qv.contiguous()
    if backend == "gpu_packed":
        # the pad word 0xFFFFFFFF is -1 in the int32 view
        dp = _pad_to(doc_ids, Dp, 0, -1)
        return sparse_match_packed(dp, qi, qv)[:D]
    di = _pad_to(doc_ids, Dp, 0, -1)
    dv = _pad_to(doc_vals, Dp, 0, 0.0)
    return sparse_match(di, dv, qi, qv)[:D]


def cosine_scores(corr: torch.Tensor, doc_norms: torch.Tensor,
                  q_norms: torch.Tensor) -> torch.Tensor:
    """corr: [D, L]; doc_norms: [D]; q_norms: [L] -> cosine in [-1, 1]."""
    denom = doc_norms[:, None] * q_norms[None, :]
    return torch.where(denom > 0, corr / torch.clamp(denom, min=1e-12),
                       -torch.inf)


def fused_topk(tiles: torch.Tensor, q_ids: torch.Tensor,
               q_vals: torch.Tensor, q_norms: torch.Tensor, *, k: int,
               block_docs: int, block_query: int = 512
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``gpu_fused`` scoring surface: packed doc tiles ([T, cap] from
    ``kernels.fused.tile_stream``) + merged query stream -> folded
    (vals [L, k], ids [L, k]) winners.

    Each doc tile emits its best ``min(k, block_docs)`` candidates and the
    fold concatenates them in tile order, so ties resolve exactly as a
    flat global top-k over document rows would (``core.topk.fold_topk``)."""
    T = tiles.shape[0]
    L_ = q_vals.shape[1]
    kp = min(k, block_docs)
    dev = tiles.device
    if T == 0 or L_ == 0:
        # empty corpus / empty batch: the same (-inf, -1) no-result rows
        # the staged path's local_topk padding produces
        return (torch.full((L_, k), -torch.inf, device=dev),
                torch.full((L_, k), -1, dtype=torch.int32, device=dev))
    Qm = q_ids.shape[0]
    tq = min(block_query, max(Qm, 8))
    Qp = max(-(-Qm // tq) * tq, tq)      # >= one tile even when Qm == 0
    qi = _pad_to(q_ids, Qp, 0, QUERY_PAD)
    qi = torch.where(qi < 0, QUERY_PAD, qi).contiguous()
    qv = _pad_to(q_vals, Qp, 0, 0.0).contiguous()
    pv, pi = fused_match_topk(tiles, qi, qv, q_norms.contiguous(),
                              block_docs=block_docs, kp=kp)
    # concatenate per-tile candidates in tile order, then fold to k
    cv = pv.permute(1, 0, 2).reshape(L_, T * kp)
    ci = pi.permute(1, 0, 2).reshape(L_, T * kp)
    return fold_topk(cv, ci, k)
