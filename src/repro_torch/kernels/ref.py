"""The gather path: backend ``torch``, the port of ``repro.kernels.ref``.

Scores by dense scatter (exact, no sentinel subtleties): each query becomes
a dense vocab vector; a document's partial products are gathers at its ELL
ids. Returns raw correlation scores (cosine numerator); normalization is
applied by ops.cosine_scores on every backend.
"""
from __future__ import annotations

import torch


def dense_query(q_ids: torch.Tensor, q_vals: torch.Tensor,
                vocab_size: int) -> torch.Tensor:
    """q_ids: [Qm] int32 (pad < 0), q_vals: [Qm, L] -> [V, L]."""
    safe = q_ids.clamp(0, vocab_size - 1).long()
    valid = (q_ids >= 0)[:, None]
    vals = torch.where(valid, q_vals.float(), 0.0)
    out = torch.zeros((vocab_size, q_vals.shape[1]), dtype=torch.float32,
                      device=q_vals.device)
    return out.index_add_(0, safe, vals)


def sparse_match_ref(doc_ids: torch.Tensor, doc_vals: torch.Tensor,
                     q_ids: torch.Tensor, q_vals: torch.Tensor,
                     vocab_size: int) -> torch.Tensor:
    """doc_ids/doc_vals: [D, K] (-1 pad); q_ids: [Qm]; q_vals: [Qm, L].
    Returns correlation scores [D, L] (fp32)."""
    qd = dense_query(q_ids, q_vals, vocab_size)           # [V, L]
    safe = doc_ids.clamp(0, vocab_size - 1).long()
    gathered = qd[safe]                                   # [D, K, L]
    valid = (doc_ids >= 0)[..., None]
    pp = torch.where(valid, doc_vals[..., None].float() * gathered, 0.0)
    return pp.sum(dim=1)                                  # [D, L]
