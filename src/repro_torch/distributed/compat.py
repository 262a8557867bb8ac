"""The collectives of the mesh: the one site that calls
``torch.distributed``. The search engine, ``core.topk`` and the LM's
mesh path call nothing else.

The port of ``repro.distributed.compat``, which is the reference's one
``shard_map`` import site; here each rank runs its own process, so what
``shard_map`` and the SPMD partitioner leave implicit is written out,
each over one named axis (or, for the reductions, several) of a
``MeshCtx``:

  - ``all_gather_axis``: ``lax.all_gather(..., tiled=True)``, in the
    axis's coordinate order, of an activation whose downstream work is
    replicated over the axis (the vocabulary's logits, the MoE's routed
    output, Mamba's ``y``); ``fsdp_gather_axis``: the same gather of a
    weight's FSDP block; ``gather_parts_axis``: of an activation whose
    downstream work is split over the axis (``sp_residual``'s rows
    entering a column-parallel product);
  - ``reduce_scatter_axis``: the sum over the axis, each rank keeping
    its block along a dim (``sp_residual``'s row-parallel exits);
  - ``all_reduce_axis``: ``lax.psum`` (or ``lax.pmax``): the row-parallel
    products, the vocabulary-parallel embedding and cross entropy,
    flash-decoding;
  - ``to_parallel``: the identity, where replicated values enter work
    that is split over an axis (a column-parallel product);
  - ``pmean_axis``: ``lax.pmean`` (the MoE's aux statistics);
  - ``all_to_all_axis``: ``lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=False)``, the MoE's dispatch;
  - ``ppermute``: ``lax.ppermute``;
  - ``gather_first``: a gather onto the axis's first coordinate alone
    (a checkpoint's save), no gradient.

*Gradients.* Every collective but ``ppermute`` and the max carries
autograd (a ``torch.autograd.Function``; its forward is the collective
as above, bit for bit). A backward depends on how the result is used,
so it follows one convention, the one the training step keeps
(``models/model.py`` ``loss_fn``): each rank's loss is a share; the
shares are summed over the dp axes (``ctx.dp_axes``), and over the
``model`` axis every rank holds the same share, counted once. So the
upstream gradient of a value replicated over ``model`` is the same on
every ``model`` rank, and that of a value replicated over a dp axis is
each rank's own share's. From that:

  - ``fsdp_gather_axis``: each rank of the axis used the whole weight on
    its own share of the batch, so the backward sums the upstream
    gradients over the axis and keeps the rank's block (a
    reduce-scatter), in f32, rounded once to the gradient's dtype;
  - ``all_gather_axis``: the downstream work is replicated, so every
    rank holds the same upstream gradient, and the backward keeps the
    rank's block (a slice, no sum); ``gather_parts_axis``: each rank's
    downstream work is a part, so the backward is ``fsdp_gather_axis``'s
    reduce-scatter;
  - ``reduce_scatter_axis``: each rank's block feeds its own work, and
    the backward gathers the blocks' gradients (an all-gather);
  - ``all_reduce_axis`` (sum): Megatron's "g": the sum feeds replicated
    work, and the backward is the identity;
  - ``to_parallel``: Megatron's "f": each rank's downstream work is a
    part, and the backward sums the parts over the axes;
  - ``pmean_axis``: over ``model`` (replicated downstream) the backward
    is ``g / size``; over a dp axis it is the sum of ``g`` over the
    axis divided by its size;
  - ``all_to_all_axis``: the backward is the reverse all-to-all (the
    same exchange of the gradient's blocks);
  - the max (``op="max"``) carries no gradient: callers take it of
    values without one (the softmax's shift).

Collectives in a backward run on autograd's thread, in the order of the
graph, which is the same on every rank (no hook whose order depends on
data).

The wire follows the axis group's backend (``dist.get_backend``), which
the caller chose when it built the group. Under NCCL the tensors stay on
the card. Under gloo, which moves host tensors, they are copied to the
host and back. On a ``single_device_ctx`` (no DeviceMesh) every
collective is the identity, and so is a collective over an axis of
one rank.

``stats``, ``None`` unless a caller measures, takes each collective's
call, bytes sent and host seconds (the card synchronized before and
after, so a measured run is slower than an unmeasured one); those of a
backward are also added under ``backward_calls``, ``backward_bytes``
and ``backward_seconds``; and under ``by``, keyed ``"op/axis"``
(``all_gather``, ``all_reduce``, ``all_reduce_max``, ``reduce_scatter``,
``all_to_all``, ``gather``), each call's and its bytes, forward and
backward apart.

*The dry mode.* On a ctx whose mesh is a ``meshctx.DryMesh`` (a shape,
axis names and one rank's coordinates, no process group) the
collectives move nothing: each returns an empty tensor of its result's
shape on the input's device (meta, in the dry run) and counts its call
and bytes in ``stats`` as the wire would.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.distributed.meshctx import MeshCtx


stats: Optional[dict] = None

Axes = Union[str, Sequence[str]]
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _on_card(group) -> bool:
    return "nccl" in dist.get_backend(group)


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def _counted(t: torch.Tensor, op: str, axis: str, backward: bool = False):
    """Add one call of ``t``'s bytes and its host seconds to ``stats``
    (and to its ``backward_`` keys for a backward's collective), and the
    call and bytes under ``stats["by"]["op/axis"]``."""
    if stats is None:
        yield
        return
    _sync(t)
    t0 = time.perf_counter()
    yield
    _sync(t)
    seconds = time.perf_counter() - t0
    keys = ("", "backward_") if backward else ("",)
    n = t.numel() * t.element_size()
    for k in keys:
        stats[k + "calls"] = stats.get(k + "calls", 0) + 1
        stats[k + "bytes"] = stats.get(k + "bytes", 0) + n
        stats[k + "seconds"] = stats.get(k + "seconds", 0.0) + seconds
    # a new dict each time: a shallow copy of ``stats`` stays as it was
    key = f"{op}/{axis}"
    one = dict(stats.get("by", {}).get(key, {}))
    for k in keys:
        one[k + "calls"] = one.get(k + "calls", 0) + 1
        one[k + "bytes"] = one.get(k + "bytes", 0) + n
    stats["by"] = {**stats.get("by", {}), key: one}


def _dry(ctx: MeshCtx) -> bool:
    return getattr(ctx.mesh, "dry", False)


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _trivial(ctx: MeshCtx, axis: str) -> bool:
    return ctx.mesh is None or ctx.shape[axis] == 1


def _ordered_group(ctx: MeshCtx, axis: str):
    """The axis's group, whose ranks must be in the axis's coordinate
    order (DeviceMesh builds them so) for the collectives that split by
    group rank."""
    group = ctx.group(axis)
    ranks = dist.get_process_group_ranks(group)
    if ranks != ctx.axis_ranks(axis):
        raise RuntimeError(f"the {axis!r} group's ranks {ranks} are not in "
                           f"the axis's coordinate order "
                           f"{ctx.axis_ranks(axis)}")
    return group


# ---------------------------------------------------------------------------
# the wire, without autograd
# ---------------------------------------------------------------------------
def _gather(t, ctx, axis, dim, backward=False):
    with _counted(t, "all_gather", axis, backward):
        if _dry(ctx):
            shape = list(t.shape)
            shape[dim] *= ctx.shape[axis]
            return t.new_empty(shape)
        group = _ordered_group(ctx, axis)
        src = t.movedim(dim, 0).contiguous()
        if not _on_card(group):
            src = src.cpu()
        out = src.new_empty((src.shape[0] * ctx.shape[axis],)
                            + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        return out.to(t.device).movedim(0, dim).contiguous()


def _reduce(t, ctx, axes, op="sum", backward=False):
    out = t
    for axis in _axes(axes):
        if _trivial(ctx, axis):
            continue
        with _counted(out, "all_reduce" + ("_max" if op == "max" else ""),
                      axis, backward):
            if _dry(ctx):
                out = torch.empty_like(out)
                continue
            group = ctx.group(axis)
            buf = out.contiguous() if _on_card(group) else out.cpu()
            if buf.data_ptr() == t.data_ptr():
                buf = buf.clone()
            dist.all_reduce(buf, op=_OPS[op], group=group)
            out = buf
    return out.to(t.device)


def _reduce_scatter(g, ctx, axis, dim, backward=True):
    """The sum of ``g`` over ``axis`` in f32 (or ``g``'s wider dtype),
    this rank's block along ``dim``, rounded to ``g``'s dtype. Under
    gloo an all-reduce of the whole, then the block: gloo's own
    reduce-scatter is slower (``benchmarks/port_gloo_wire.py``)."""
    n = ctx.shape[axis]
    wide = torch.promote_types(g.dtype, torch.float32)
    src = g.to(wide).movedim(dim, 0).contiguous()
    # the wider bytes are sent
    with _counted(src, "reduce_scatter", axis, backward):
        if _dry(ctx):
            shape = list(g.shape)
            shape[dim] //= n
            return g.new_empty(shape)
        group = _ordered_group(ctx, axis)
        if _on_card(group):
            out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
            dist.reduce_scatter_tensor(out, src, group=group)
        else:
            src = src.cpu()
            if src.data_ptr() == g.data_ptr():  # the sum is in place
                src = src.clone()
            dist.all_reduce(src, group=group)
            out = _block(src, ctx, axis, 0)
        return out.movedim(0, dim).to(device=g.device, dtype=g.dtype)


def _exchange(t, ctx, axis, backward=False):
    with _counted(t, "all_to_all", axis, backward):
        if _dry(ctx):
            return torch.empty_like(t)
        group = _ordered_group(ctx, axis)
        src = t.contiguous() if _on_card(group) else t.cpu()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        return out.to(t.device)


def _block(g, ctx, axis, dim):
    n = g.shape[dim] // ctx.shape[axis]
    return g.narrow(dim, ctx.coord(axis) * n, n).contiguous()


# ---------------------------------------------------------------------------
# the collectives, with their backwards (the module's convention)
# ---------------------------------------------------------------------------
class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fc, t, ctx, axis, dim, reduce):
        fc.ctx, fc.axis, fc.dim, fc.reduce = ctx, axis, dim, reduce
        return _gather(t, ctx, axis, dim)

    @staticmethod
    def backward(fc, g):
        if fc.reduce:
            return _reduce_scatter(g, fc.ctx, fc.axis, fc.dim), None, None, \
                None, None
        return _block(g, fc.ctx, fc.axis, fc.dim), None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(fc, t, ctx, axis, dim):
        fc.ctx, fc.axis, fc.dim = ctx, axis, dim
        return _reduce_scatter(t, ctx, axis, dim, backward=False)

    @staticmethod
    def backward(fc, g):
        return _gather(g, fc.ctx, fc.axis, fc.dim, backward=True), None, \
            None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(fc, t, ctx, axes):
        return _reduce(t, ctx, axes)

    @staticmethod
    def backward(fc, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(fc, t, ctx, axes):
        fc.ctx, fc.axes = ctx, axes
        return t.view_as(t)

    @staticmethod
    def backward(fc, g):
        return _reduce(g, fc.ctx, fc.axes, backward=True), None, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(fc, t, ctx, axes):
        fc.ctx, fc.axes = ctx, axes
        return _reduce(t, ctx, axes) / ctx.axes_size(axes)

    @staticmethod
    def backward(fc, g):
        ctx = fc.ctx
        dp = [a for a in fc.axes if a in ctx.dp_axes]
        if dp:
            g = _reduce(g, ctx, dp, backward=True)
        return g / ctx.axes_size(fc.axes), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(fc, t, ctx, axis):
        fc.ctx, fc.axis = ctx, axis
        return _exchange(t, ctx, axis)

    @staticmethod
    def backward(fc, g):
        return _exchange(g, fc.ctx, fc.axis, backward=True), None, None


def all_gather_axis(t: torch.Tensor, ctx: MeshCtx, axis: str,
                    dim: int) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated along ``dim`` in
    the axis's coordinate order (the same on every rank of the axis); on
    an axis of one rank, ``t`` itself. For a result whose downstream
    work is replicated over the axis: the backward keeps the rank's
    block of the gradient."""
    if _trivial(ctx, axis):
        return t
    return _Gather.apply(t, ctx, axis, dim, False)


def fsdp_gather_axis(t: torch.Tensor, ctx: MeshCtx, axis: str,
                     dim: int) -> torch.Tensor:
    """``all_gather_axis`` of a weight's block, used whole by every rank
    on its own share of the batch: the backward is a reduce-scatter (the
    gradient summed over the axis in f32, the rank's block kept)."""
    if _trivial(ctx, axis):
        return t
    return _Gather.apply(t, ctx, axis, dim, True)


def gather_parts_axis(t: torch.Tensor, ctx: MeshCtx, axis: str,
                      dim: int) -> torch.Tensor:
    """``all_gather_axis`` of an activation whose downstream work is
    split over the axis, each rank's a part (``sp_residual``'s rows
    entering a column-parallel product): the backward sums the parts'
    gradients over the axis and keeps the rank's block (a
    reduce-scatter, in f32, rounded once to the gradient's dtype)."""
    if _trivial(ctx, axis):
        return t
    return _Gather.apply(t, ctx, axis, dim, True)


def reduce_scatter_axis(t: torch.Tensor, ctx: MeshCtx, axis: str,
                        dim: int) -> torch.Tensor:
    """The sum of ``t`` over ``axis`` in f32 (or ``t``'s wider dtype),
    the rank's block along ``dim`` in the axis's coordinate order,
    rounded once to ``t``'s dtype (``lax.psum_scatter``). The backward
    gathers the blocks' gradients along ``dim`` (each rank's block feeds
    its own work)."""
    if _trivial(ctx, axis):
        return t
    return _Scatter.apply(t, ctx, axis, dim)


@torch.no_grad()
def gather_first(t: torch.Tensor, ctx: MeshCtx, axis: str,
                 dim: int) -> Optional[torch.Tensor]:
    """``all_gather_axis``'s result on the axis's first coordinate alone
    (``dist.gather``: a quarter of the traffic on four ranks), None on
    the others; no gradient. The result stays where the wire leaves it:
    on the host under gloo, on the card under NCCL. A checkpoint's save
    gathers so, for the host."""
    if _trivial(ctx, axis):
        return t
    group = ctx.group(axis)
    ranks = ctx.axis_ranks(axis)
    with _counted(t, "gather", axis):
        src = t.contiguous() if _on_card(group) else t.cpu()
        first = ctx.coord(axis) == 0
        parts = [torch.empty_like(src) for _ in ranks] if first else None
        dist.gather(src, parts, dst=ranks[0], group=group)
        if not first:
            return None
        by_group_rank = dist.get_process_group_ranks(group)
        ordered = [parts[by_group_rank.index(r)] for r in ranks]
        return torch.cat(ordered, dim)


def ppermute(t: torch.Tensor, ctx: MeshCtx, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: for each ``(src, dst)`` pair of coordinates along
    ``axis``, ``src``'s ``t`` lands on ``dst``; a rank no pair sends to
    gets zeros (no gradient)."""
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


def all_reduce_axis(t: torch.Tensor, ctx: MeshCtx, axes: Axes,
                    op: str = "sum") -> torch.Tensor:
    """``lax.psum`` (``op="sum"``) or ``lax.pmax`` (``"max"``) of ``t``
    over ``axes`` (one axis name or several, reduced one after the
    other), on ``t``'s device and the same on every rank of the axes;
    ``t`` itself is never written. The sum's backward is the identity
    (its result feeds replicated work); the max carries no gradient."""
    axes = tuple(a for a in _axes(axes) if not _trivial(ctx, a))
    if not axes:
        return t
    if op == "max":
        return _reduce(t.detach(), ctx, axes, "max")
    return _Sum.apply(t, ctx, axes)


def to_parallel(t: torch.Tensor, ctx: MeshCtx, axes: Axes) -> torch.Tensor:
    """``t`` itself, where a value replicated over ``axes`` enters work
    that each rank of them does a part of: the backward sums the parts'
    gradients over the axes (Megatron's "f")."""
    axes = tuple(a for a in _axes(axes) if not _trivial(ctx, a))
    if not axes or not torch.is_grad_enabled() or not t.requires_grad:
        return t
    return _Enter.apply(t, ctx, axes)


def pmean_axis(t: torch.Tensor, ctx: MeshCtx, axes: Axes) -> torch.Tensor:
    """``lax.pmean``: the sum over ``axes``, divided by their size. The
    backward is ``g / size`` over ``model``, and the sum of ``g`` over
    a dp axis divided by its size (the module's convention)."""
    axes = _axes(axes)
    if all(_trivial(ctx, a) for a in axes):
        return t / ctx.axes_size(axes) if ctx.mesh is not None else t
    return _Mean.apply(t, ctx, axes)


def all_to_all_axis(t: torch.Tensor, ctx: MeshCtx,
                    axis: str) -> torch.Tensor:
    """``lax.all_to_all(t, axis, split_axis=0, concat_axis=0,
    tiled=False)``: ``t`` is ``[M, ...]`` with M the axis's size; block
    ``j`` goes to coordinate ``j``, and the result's block ``i`` is what
    coordinate ``i`` sent here. The backward is the same exchange of the
    gradient."""
    if _trivial(ctx, axis):
        return t
    return _Exchange.apply(t, ctx, axis)
