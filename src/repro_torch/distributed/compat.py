"""The collectives of the mesh: the one site that calls
``torch.distributed``. The search engine, ``core.topk`` and the LM's
mesh path call nothing else.

The port of ``repro.distributed.compat``, which is the reference's one
``shard_map`` import site; here each rank runs its own process, so what
``shard_map`` and the SPMD partitioner leave implicit is written out,
each over one named axis (or, for the reductions, several) of a
``MeshCtx``:

  - ``all_gather_axis``: ``lax.all_gather(..., tiled=True)``, in the
    axis's coordinate order (the FSDP gathers, the vocabulary's logits);
  - ``all_reduce_axis``: ``lax.psum`` (or ``lax.pmax``): the row-parallel
    products, the vocabulary-parallel embedding, flash-decoding;
  - ``pmean_axis``: ``lax.pmean`` (the MoE's aux statistics);
  - ``all_to_all_axis``: ``lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=False)``, the MoE's dispatch;
  - ``ppermute``: ``lax.ppermute``.

The wire follows the axis group's backend (``dist.get_backend``), which
the caller chose when it built the group. Under NCCL the tensors stay on
the card. Under gloo, which moves host tensors, they are copied to the
host and back. On a ``single_device_ctx`` (no DeviceMesh) every
collective is the identity, and so is a collective over an axis of
one rank.

``stats``, ``None`` unless a caller measures, takes each collective's
call, bytes sent and host seconds (the card synchronized before and
after, so a measured run is slower than an unmeasured one).
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.distributed.meshctx import MeshCtx


stats: Optional[dict] = None


def _on_card(group) -> bool:
    return "nccl" in dist.get_backend(group)


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def _counted(t: torch.Tensor):
    """Add one call of ``t``'s bytes and its host seconds to ``stats``."""
    if stats is None:
        yield
        return
    _sync(t)
    t0 = time.perf_counter()
    yield
    _sync(t)
    stats["calls"] = stats.get("calls", 0) + 1
    stats["bytes"] = stats.get("bytes", 0) + t.numel() * t.element_size()
    stats["seconds"] = stats.get("seconds", 0.0) + time.perf_counter() - t0


def all_gather_axis(t: torch.Tensor, ctx: MeshCtx, axis: str,
                    dim: int) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated along ``dim`` in
    the axis's coordinate order (the same on every rank of the axis); on
    an axis of one rank, ``t`` itself."""
    if ctx.mesh is None or ctx.shape[axis] == 1:
        return t
    with _counted(t):
        group = ctx.group(axis)
        src = t.contiguous() if _on_card(group) else t.cpu()
        by_group_rank = dist.get_process_group_ranks(group)
        parts: List[torch.Tensor] = [torch.empty_like(src)
                                     for _ in by_group_rank]
        dist.all_gather(parts, src, group=group)
        ordered = [parts[by_group_rank.index(r)]
                   for r in ctx.axis_ranks(axis)]
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


Axes = Union[str, Sequence[str]]
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def all_reduce_axis(t: torch.Tensor, ctx: MeshCtx, axes: Axes,
                    op: str = "sum") -> torch.Tensor:
    """``lax.psum`` (``op="sum"``) or ``lax.pmax`` (``"max"``) of ``t``
    over ``axes`` (one axis name or several, reduced one after the
    other), on ``t``'s device and the same on every rank of the axes;
    ``t`` itself is never written."""
    out = t
    for axis in _axes(axes):
        if ctx.mesh is None or ctx.shape[axis] == 1:
            continue
        with _counted(out):
            group = ctx.group(axis)
            buf = out.contiguous() if _on_card(group) else out.cpu()
            if buf.data_ptr() == t.data_ptr():
                buf = buf.clone()
            dist.all_reduce(buf, op=_OPS[op], group=group)
            out = buf
    return out.to(t.device)


def pmean_axis(t: torch.Tensor, ctx: MeshCtx, axes: Axes) -> torch.Tensor:
    """``lax.pmean``: the sum over ``axes``, divided by their size."""
    return all_reduce_axis(t, ctx, axes) / ctx.axes_size(axes)


def all_to_all_axis(t: torch.Tensor, ctx: MeshCtx,
                    axis: str) -> torch.Tensor:
    """``lax.all_to_all(t, axis, split_axis=0, concat_axis=0,
    tiled=False)``: ``t`` is ``[M, ...]`` with M the axis's size; block
    ``j`` goes to coordinate ``j``, and the result's block ``i`` is what
    coordinate ``i`` sent here."""
    if ctx.mesh is None or ctx.shape[axis] == 1:
        return t
    group = ctx.group(axis)
    # all_to_all_single splits by group rank; DeviceMesh builds its groups
    # with the ranks in the axis's coordinate order
    ranks = dist.get_process_group_ranks(group)
    if ranks != ctx.axis_ranks(axis):
        raise RuntimeError(f"the {axis!r} group's ranks {ranks} are not in "
                           f"the axis's coordinate order "
                           f"{ctx.axis_ranks(axis)}")
    with _counted(t):
        src = t.contiguous() if _on_card(group) else t.cpu()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        return out.to(t.device)
