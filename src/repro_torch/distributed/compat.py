"""The collectives of the search engine's mesh: the one site that calls
``torch.distributed``. The engine and ``core.topk`` call nothing else.

The port of ``repro.distributed.compat``, which is the reference's one
``shard_map`` import site; here each rank runs its own process, so what
``shard_map`` leaves implicit is written out: ``all_gather_axis`` is
``lax.all_gather(..., tiled=True)`` and ``ppermute`` is
``lax.ppermute``, both over one named axis of a ``MeshCtx``.

The wire follows the axis group's backend (``dist.get_backend``). Under
NCCL the tensors stay on the card. Under gloo, which moves host tensors,
they are copied to the host and back: the engine sends only [L, k]
candidate lists this way, never the corpus. On a ``single_device_ctx``
(no DeviceMesh) every collective is the identity.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.meshctx import MeshCtx


def _on_card(group) -> bool:
    return "nccl" in dist.get_backend(group)


def all_gather_axis(t: torch.Tensor, ctx: MeshCtx, axis: str,
                    dim: int) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated along ``dim`` in
    the axis's coordinate order (the same on every rank of the axis)."""
    if ctx.mesh is None:
        return t
    group = ctx.group(axis)
    src = t.contiguous() if _on_card(group) else t.cpu()
    by_group_rank = dist.get_process_group_ranks(group)
    parts: List[torch.Tensor] = [torch.empty_like(src)
                                 for _ in by_group_rank]
    dist.all_gather(parts, src, group=group)
    ordered = [parts[by_group_rank.index(r)] for r in ctx.axis_ranks(axis)]
    return torch.cat(ordered, dim).to(t.device)


def ppermute(t: torch.Tensor, ctx: MeshCtx, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: for each ``(src, dst)`` pair of coordinates along
    ``axis``, ``src``'s ``t`` lands on ``dst``; a rank no pair sends to
    gets zeros."""
    if ctx.mesh is None:
        return torch.zeros_like(t) if (0, 0) not in perm else t
    group = ctx.group(axis)
    src = t.contiguous() if _on_card(group) else t.cpu()
    out = torch.zeros_like(src)
    me, ranks = ctx.coord(axis), ctx.axis_ranks(axis)
    ops = []
    for s, d in perm:
        if s == me == d:
            out.copy_(src)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src, ranks[d], group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(t.device)
