"""Top-k reduction primitives (the paper's result reporting path), in torch.

The port of ``repro.core.topk``: per-device top-k over the local corpus
shard, then a reduction along the mesh axes (``tree_topk``, or the
log-depth ``tree_topk_ppermute``), so only O(k) candidates cross each
link — "only documentIDs with high scores are reported". ``lax.top_k``
orders floats by their total order (NaN above +inf, -NaN below -inf,
-0.0 below +0.0) and breaks ties by the lower index; ``torch.topk``
promises no tie order. So every ranking here is a stable descending
``torch.sort`` of a total-order integer key, which reproduces
``lax.top_k`` element for element.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import compat
from repro_torch.distributed.meshctx import MeshCtx


def rank_key(vals: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 key whose integer order is the floats' total
    order (the comparator XLA's TopK uses)."""
    bits = vals.float().contiguous().view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def top_k(vals: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: (values, int64 indices)."""
    _, idx = torch.sort(rank_key(vals), dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return torch.gather(vals, -1, idx), idx


def local_topk(scores: torch.Tensor, doc_ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores: [D, L]; doc_ids: [D] -> (vals [L, k], ids [L, k] int32).

    Padding rows (doc_id < 0) are masked to -inf so they never outrank a
    real document, and their reported id is forced to -1. When k exceeds
    the row count the list is padded with (-inf, -1) placeholders.

    Id masking is by *row validity* (doc_id >= 0), never by score
    finiteness: a real document whose score overflowed to +inf (or went
    NaN) is still a real document and reports its real id."""
    scores = torch.where(doc_ids[:, None] >= 0, scores, -torch.inf)
    k_eff = min(k, scores.shape[0])
    vals, idx = top_k(scores.T, k_eff)                    # [L, k_eff]
    hit = doc_ids[idx]
    ids = torch.where(hit >= 0, hit, -1).to(torch.int32)
    if k_eff < k:
        vals = F.pad(vals, (0, k - k_eff), value=-torch.inf)
        ids = F.pad(ids, (0, k - k_eff), value=-1)
    return vals, ids


def fold_topk(vals: torch.Tensor, ids: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an [L, C] candidate list down to the best [L, k].

    Ties break by lower column index, so candidates must be concatenated
    in priority order (earlier slab / tile first). A list shorter than k
    is padded with (-inf, -1) placeholders."""
    c = vals.shape[1]
    if c < k:
        vals = F.pad(vals, (0, k - c), value=-torch.inf)
        ids = F.pad(ids, (0, k - c), value=-1)
    v, idx = top_k(vals, k)
    return v, torch.gather(ids, 1, idx)


def merge_topk(vals_a, ids_a, vals_b, ids_b, k: int):
    """Merge two [L, k] candidate sets."""
    return fold_topk(torch.cat([vals_a, vals_b], dim=1),
                     torch.cat([ids_a, ids_b], dim=1), k)


def tree_topk(vals: torch.Tensor, ids: torch.Tensor, k: int, ctx: MeshCtx,
              axis: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce [L, k] candidates across the ranks of ``axis``: gather them
    in the axis's coordinate order, then fold. Ties therefore break
    toward the lower coordinate, which holds the lower document rows."""
    g_vals = compat.all_gather_axis(vals, ctx, axis, dim=1)
    g_ids = compat.all_gather_axis(ids, ctx, axis, dim=1)
    return fold_topk(g_vals, g_ids, k)


def tree_topk_ppermute(vals: torch.Tensor, ids: torch.Tensor, k: int,
                       ctx: MeshCtx, axis: str, axis_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-depth butterfly merge via ppermute (the collective-light
    variant). Each step merges a rank's set with its partner's, the
    lower coordinate's first, so ties break as in ``tree_topk`` and
    every rank ends with the same list."""
    me = ctx.coord(axis)
    step = 1
    while step < axis_size:
        perm = [(i, i ^ step) for i in range(axis_size)]
        ov = compat.ppermute(vals, ctx, axis, perm)
        oi = compat.ppermute(ids, ctx, axis, perm)
        if me & step:                    # the partner is the lower half
            vals, ids = merge_topk(ov, oi, vals, ids, k)
        else:
            vals, ids = merge_topk(vals, ids, ov, oi, k)
        step *= 2
    return vals, ids
