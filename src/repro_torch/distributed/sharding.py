"""Parameter sharding rules (2-D: FSDP over ``data`` x TP over ``model``):
the port of ``repro.distributed.sharding``.

Rules are name-based over the param tree with divisibility guards: a dim
is sharded over an axis only if it divides evenly and, for attention,
head boundaries stay aligned; otherwise that dim is replicated (qwen2's
14 heads on a model axis of 4 or 16: its attention weights replicate
over ``model`` while the FFN and the vocabulary still shard). ``pod`` is
a pure data-parallel axis: params are replicated over it.

A spec here is a tuple with one entry a dimension: ``None``, an axis
name, or a tuple of names (the first major), as the reference's
``PartitionSpec`` entries are, padded with ``None`` to the leaf's rank.
The reference stacks each group of layers along a leading axis; the
port keeps one dict a layer (``carry._unstacked``), so the spec of a
layer's leaf is the reference's rule applied to the stacked shape, with
the layer axis dropped (``leaf_spec(..., stacked=True)``).

``shard_params`` cuts a whole tree into this rank's blocks, and
``sharded_init`` draws the params "born sharded": each leaf in
``M.init``'s order on the rank's device, cut to the rank's block before
the next is drawn, so that no rank holds more than one whole leaf, and
every block is the slice of ``M.init(cfg, seed=seed)``'s leaf bit for
bit. The model takes the blocks as local tensors.
"""
from __future__ import annotations

import functools
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.meshctx import MeshCtx

# weight classes: which of the last two dims carries TP
_OUT_TP = {"wq", "wk", "wv", "wg", "w_gate", "w_up", "wr"}
_IN_TP = {"wo", "w_down", "out_proj", "wv_cm"}
_REPLICATE = {"router", "wA", "wB", "conv_w", "A_log", "D", "dt_bias",
              "w0", "u", "in_proj"}
# the port's per-layer lists, stacked ``[n, ...]`` in the reference
STACKED = ("blocks", "cross_blocks", "mamba")
MESH_FAMILIES = ("dense", "moe")


def entry(axes):
    """A spec entry in ``PartitionSpec``'s canonical form: one axis as
    its name, several as a tuple."""
    axes = tuple(axes)
    return axes[0] if len(axes) == 1 else axes


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _rule(names, shape, cfg: ModelConfig, ctx: MeshCtx) -> tuple:
    """The reference's ``_leaf_spec`` rule for rule, on the reference's
    (stacked) shape; entries as its ``P(...)`` takes them."""
    fsdp, tp = ctx.fsdp_axis, ctx.tp_axis
    fs, ts = ctx.shape[fsdp], ctx.shape[tp]
    name = names[-1]
    parent = names[-2] if len(names) > 1 else ""

    # embedding
    if name == "table":
        return (tp if _div(shape[0], ts) else None,
                fsdp if _div(shape[1], fs) else None)
    if name == "head":
        return (fsdp if _div(shape[0], fs) else None,
                tp if _div(shape[1], ts) else None)

    # attention head guards
    attn_ok_q = _div(cfg.n_heads, ts)
    attn_ok_kv = _div(cfg.n_kv_heads, ts)
    in_attn = parent == "attn" or name in ("wq", "wk", "wv", "wo")

    # rwkv channel-mix value matrix is named "wv" but is [ff, d] (in-TP);
    # decided before the _OUT_TP branch
    if parent == "cm" and name == "wv":
        lead = (None,) * (len(shape) - 2)
        return (*lead, tp if _div(shape[-2], ts) else None,
                fsdp if _div(shape[-1], fs) else None)

    # mamba in_proj [L, d, 2*d_in+2N+nh]: FSDP on d, the fused out dim
    # replicated (its sections are not TP-aligned)
    if name == "in_proj":
        return (None, fsdp if _div(shape[1], fs) else None, None)

    if len(shape) >= 2 and name in _OUT_TP and name not in _REPLICATE:
        tp_ok = _div(shape[-1], ts)
        if in_attn and name == "wq":
            tp_ok = tp_ok and attn_ok_q
        if in_attn and name in ("wk", "wv") and parent == "attn":
            tp_ok = tp_ok and attn_ok_kv
        lead = (None,) * (len(shape) - 2)
        # MoE experts: [L, E, d, ff]: E carries TP (EP), d carries FSDP
        if len(shape) == 4:
            return (None, tp if _div(shape[1], ts) else None,
                    fsdp if _div(shape[2], fs) else None, None)
        return (*lead, fsdp if _div(shape[-2], fs) else None,
                tp if tp_ok else None)

    if len(shape) >= 2 and name in _IN_TP:
        tp_ok = _div(shape[-2], ts)
        if name == "wo":
            tp_ok = tp_ok and attn_ok_q
        lead = (None,) * (len(shape) - 2)
        if len(shape) == 4:  # [L, E, ff, d]
            return (None, tp if _div(shape[1], ts) else None, None,
                    fsdp if _div(shape[-1], fs) else None)
        return (*lead, tp if tp_ok else None,
                fsdp if _div(shape[-1], fs) else None)

    return ()  # biases, norms, router, small tensors: replicated


def _mesh_key(ctx: MeshCtx) -> tuple:
    return (tuple(ctx.shape.items()), ctx.dp_axes, ctx.fsdp_axis,
            ctx.tp_axis)


@functools.lru_cache(maxsize=4096)
def _cached(names, shape, cfg, key, stacked):
    shape_dict, dp_axes, fsdp, tp = key
    view = _ShapeCtx(dict(shape_dict), dp_axes, fsdp, tp)
    full = ((1,) + shape) if stacked else shape
    spec = _rule(names, full, cfg, view)
    spec = tuple(spec) + (None,) * (len(full) - len(spec))
    return spec[1:] if stacked else spec


class _ShapeCtx:
    """What the rules read of a ``MeshCtx``: its axis sizes and roles."""

    def __init__(self, shape, dp_axes, fsdp_axis, tp_axis):
        self.shape, self.dp_axes = shape, dp_axes
        self.fsdp_axis, self.tp_axis = fsdp_axis, tp_axis


def leaf_spec(names, shape, cfg: ModelConfig, ctx: MeshCtx,
              stacked: bool = False) -> tuple:
    """The spec of one leaf: ``names`` its path (the rules read the last
    two names), ``shape`` the port's (whole) shape; ``stacked`` for a
    layer's leaf, whose reference twin carries a leading layer axis."""
    return _cached(tuple(str(n) for n in names), tuple(shape), cfg,
                   _mesh_key(ctx), stacked)


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _is_stacked(path) -> bool:
    return bool(path) and path[0] in STACKED


def build_param_specs(params, cfg: ModelConfig, ctx: MeshCtx):
    """Mirror the port's param tree (leaves: anything with ``.shape``,
    whole leaves) with specs."""
    return _walk(params, lambda path, leaf: leaf_spec(
        path, leaf.shape, cfg, ctx, _is_stacked(path)))


def opt_state_specs(opt_state, param_specs, ctx: MeshCtx) -> dict:
    """Specs for the optimizer state tree: f32 moments mirror the param
    spec; an int8 ``QTensor``'s payload takes the param's spec, and its
    per-block scales the leading entries and the last (blocked) axis's
    only where the blocks divide across it."""
    from repro_torch.train.optimizer import QTensor

    def one(state_leaf, spec):
        if not isinstance(state_leaf, QTensor):
            return spec
        rank = len(state_leaf.q.shape)
        entries = list(spec) + [None] * (rank - len(spec))
        if len(state_leaf.scale.shape) == rank and rank > 0:
            n_blocks = state_leaf.scale.shape[-1]
            last = entries[-1]
            ok = n_blocks % ctx.axes_size(last) == 0
            ss = (*entries[:-1], last if ok else None)
        else:
            ss = tuple(entries[:len(state_leaf.scale.shape)])
        return QTensor(q=tuple(entries), scale=ss, shape=state_leaf.shape)

    def zip_tree(state, specs):
        if isinstance(state, dict):
            return {k: zip_tree(state[k], specs[k]) for k in state}
        if isinstance(state, list):
            return [zip_tree(a, b) for a, b in zip(state, specs)]
        return one(state, specs)

    return {"step": (), "m": zip_tree(opt_state["m"], param_specs),
            "v": zip_tree(opt_state["v"], param_specs)}


def block(t: torch.Tensor, spec: tuple, ctx: MeshCtx) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` under ``spec``: a view
    of ``t``."""
    index = tuple(ctx.block(n, axes) for n, axes in zip(t.shape, spec))
    return t[index]


def _own(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy on ``device`` that shares no storage with
    ``t`` (whose whole leaf may then be freed)."""
    out = t.to(device).contiguous()
    return out.clone() if out.data_ptr() == t.data_ptr() else out


def shard_params(params, cfg: ModelConfig, ctx: MeshCtx,
                 device=None) -> Any:
    """Cut a whole param tree into this rank's blocks, on ``device``
    (default the ctx's)."""
    device = ctx.device if device is None else device

    def cut(path, leaf):
        spec = leaf_spec(path, leaf.shape, cfg, ctx, _is_stacked(path))
        return _own(block(leaf, spec, ctx), device)
    return _walk(params, cut)


def check_family(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the mesh does not run."""
    if cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family on a mesh is not ported "
            f"(the mesh serves {MESH_FAMILIES}); ROADMAP A8.5")


def sharded_init(cfg: ModelConfig, ctx: MeshCtx, seed: int = 0):
    """``M.init(cfg, seed=seed)``'s params born sharded on the ctx's
    device: the same generator on that device draws each leaf whole, in
    ``M.init``'s order, and keeps only this rank's block of it before it
    draws the next. The dense and moe families (``MESH_FAMILIES``)."""
    from repro_torch.models import transformer
    check_family(cfg)
    gen = torch.Generator(device=ctx.device).manual_seed(seed)

    def keep(path, leaf):
        spec = leaf_spec(path, leaf.shape, cfg, ctx, _is_stacked(path))
        return _own(block(leaf, spec, ctx), ctx.device)
    return transformer.init(gen, cfg, keep=keep)


def gather(t: torch.Tensor, spec: tuple, ctx: MeshCtx) -> torch.Tensor:
    """The block ``t`` of a param with its dims over the ``fsdp`` axis
    gathered whole: FSDP's gather before a weight's use. Dims over other
    axes stay as they are (a param's spec names one axis a dim)."""
    from repro_torch.distributed import compat
    for dim, axes in enumerate(spec):
        if axes == ctx.fsdp_axis:
            t = compat.all_gather_axis(t, ctx, ctx.fsdp_axis, dim)
    return t
