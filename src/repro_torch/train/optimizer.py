"""AdamW: the port of ``repro.train.optimizer``.

- f32 m and v by default;
- ``int8_states``: m and v quantized to int8 in blocks of 128 along the
  last axis, each block with an f32 absmax scale (``QTensor``); v is kept
  in the square-root domain and its denominator floored by half a
  quantum, so an entry that quantizes to 0 cannot blow up its update;
- cosine LR schedule with linear warmup, decoupled weight decay, and a
  global-norm clip.

Params are the port's tree (dicts and lists of tensors, one dict a
layer); the states mirror it, so the checkpoint manager treats them
alike. ``flatten`` fixes the leaf order: dict keys sorted, as JAX orders
them, list items in order. ``apply_updates`` updates params and states
in place, leaf by leaf, so that a step holds one leaf's f32 temporaries
at a time beside the params, grads and states (the reference returns
new trees, which XLA writes into the donated buffers); a leaf of more
than ``UPDATE_ROWS_ENTRIES`` entries goes a run of rows at a time (the
VLM's 1.05 B-entry embedding table would otherwise hold ~40 GB of
them), which every entry's arithmetic, and each block's absmax along
the last axis, leave bit for bit the same.

The arithmetic is the reference's, operation for operation in f32 (a
Python float scalar is rounded to f32 as JAX's weak types are;
``torch.round`` rounds half to even, as ``jnp.round`` does).

On a mesh (``ctx`` and the params' ``specs``, ``distributed/sharding``)
every leaf is the rank's block, and so are its gradient and its states,
laid out as ``sharding.opt_state_specs`` says. ``global_norm`` sums
each block's squares and all-reduces them over exactly the axes that
shard the leaf (a replicated block counts once). The int8 blocks are
those of the whole leaf (``Blocked``): where a rank's block of the last
dim holds whole quantization blocks, its scales are its own block of
the leaf's; where it does not (the last dim's block is not a multiple
of the quantization block, or the whole last dim is one block), a block
spans ranks of the axis that shards that dim, its absmax is a pmax over
the axis, and every rank holds all of the leaf's scales (replicated
there, as ``opt_state_specs`` lays them out).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.distributed import compat
from repro_torch.distributed.meshctx import _names

BLOCK = 128
UPDATE_ROWS_ENTRIES = 1 << 26        # a leaf's update, this many at a time


# ---------------------------------------------------------------------------
# block-wise int8 quantization
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Blocked:
    """Where a rank's block of a leaf's last dim sits in the whole leaf's:
    ``whole`` its length, ``start`` the block's first index, ``axes``
    the mesh axes that shard it (of ``ctx``)."""
    whole: int
    start: int
    axes: Tuple[str, ...]
    ctx: Any

    @property
    def b(self) -> int:
        return _block_of((self.whole,))

    @property
    def own_scales(self) -> bool:
        """Whether the rank's block holds whole quantization blocks, so
        that its scales are a block of the leaf's (``opt_state_specs``'
        rule: the blocks divide across the axes)."""
        return (self.whole // self.b) % self.ctx.axes_size(self.axes) == 0


def blocked(shape, spec, ctx) -> Optional[Blocked]:
    """The ``Blocked`` of a block of ``shape`` under the leaf's ``spec``
    on ``ctx``, or None where the last dim is whole on this rank (or the
    leaf is a scalar)."""
    if ctx is None or ctx.mesh is None or not shape:
        return None
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    axes = _names(spec[-1])
    if ctx.axes_size(axes) == 1:
        return None
    whole = shape[-1] * ctx.axes_size(axes)
    return Blocked(whole, ctx.block(whole, axes).start, axes, ctx)


@dataclasses.dataclass
class QTensor:
    q: torch.Tensor        # int8 payload, the tensor's shape
    scale: torch.Tensor    # f32 per-block absmax / 127, shape[:-1] + (n,)
    shape: Tuple[int, ...] = ()
    last: Optional[Blocked] = None   # on a mesh: the block's place


def _block_of(shape) -> int:
    """Blocks run along the last axis (BLOCK wide where it divides the
    axis, else the whole axis), so the payload has the tensor's shape."""
    last = shape[-1] if shape else 1
    return BLOCK if last % BLOCK == 0 else last


def _scale_index(t_last: Blocked, n: int, device) -> torch.Tensor:
    """For each of the block's ``n`` last-dim entries, the index of its
    quantization block among the rank's scales."""
    ids = (t_last.start + torch.arange(n, device=device)) // t_last.b
    return ids - t_last.start // t_last.b if t_last.own_scales else ids


def _spread(t: QTensor) -> torch.Tensor:
    """Each entry's scale, in the payload's shape (a block that spans
    ranks)."""
    return t.scale[..., _scale_index(t.last, t.q.shape[-1], t.q.device)]


def quantize_block(x: torch.Tensor, last: Optional[Blocked] = None
                   ) -> QTensor:
    """``x`` in int8 blocks of BLOCK along the last axis, each with its
    absmax scale; ``last``: ``x`` is a rank's block of a leaf on a mesh,
    quantized by the whole leaf's blocks."""
    shape = tuple(x.shape)
    if last is not None and not last.own_scales:
        xf = x.float()
        ids = _scale_index(last, shape[-1], x.device)
        absmax = torch.zeros(shape[:-1] + (last.whole // last.b,),
                             dtype=torch.float32, device=x.device)
        absmax = absmax.scatter_reduce(-1, ids.expand(shape), xf.abs(),
                                       "amax")
        absmax = compat.all_reduce_axis(absmax, last.ctx, last.axes,
                                        op="max")
        scale = torch.clamp(absmax / 127.0, min=1e-12)
        q = torch.clamp(torch.round(xf / scale[..., ids]), -127,
                        127).to(torch.int8)
        return QTensor(q=q, scale=scale, shape=shape, last=last)
    if not shape:
        return QTensor(q=torch.zeros((), dtype=torch.int8, device=x.device),
                       scale=x.abs().float()[None] / 127.0, shape=shape)
    b = _block_of(shape)
    xb = x.float().reshape(shape[:-1] + (shape[-1] // b, b))
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return QTensor(q=q.reshape(shape), scale=scale[..., 0], shape=shape,
                   last=last)


def _quantum_floor(t: QTensor) -> torch.Tensor:
    """Half a quantum of each stored value (its error bound), in the
    tensor's shape."""
    if t.last is not None and not t.last.own_scales:
        return _spread(t) * 0.5
    if not t.shape:
        return t.scale[0] * 0.5
    b = _block_of(t.shape)
    return torch.repeat_interleave(t.scale, b, dim=-1).reshape(t.shape) * 0.5


def dequantize_block(t: QTensor) -> torch.Tensor:
    if t.last is not None and not t.last.own_scales:
        return t.q.float() * _spread(t)
    if not t.shape:
        return t.q.float() * t.scale[0]
    b = _block_of(t.shape)
    qb = t.q.float().reshape(t.shape[:-1] + (t.shape[-1] // b, b))
    return (qb * t.scale[..., None]).reshape(t.shape)


# ---------------------------------------------------------------------------
# trees: dicts and lists of tensors (or QTensors)
# ---------------------------------------------------------------------------
def flatten(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)]: dict keys sorted, list items in order; a QTensor
    is a leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten(tree[k],
                                                           prefix + (k,))]
    if isinstance(tree, list):
        return [kv for i, t in enumerate(tree)
                for kv in flatten(t, prefix + (i,))]
    return [(prefix, tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same places of
    ``rest``), in ``flatten``'s order; the same structure back."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def unflatten(like, leaves):
    """``like``'s structure with ``leaves`` in ``flatten``'s order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------
def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def init_state(cfg: OptimizerConfig, params, ctx=None, specs=None) -> dict:
    """{"step": int32 0, "m", "v": zeros in the params' tree, f32 or
    QTensor}, on the params' device; on a mesh (``ctx``, the params'
    ``specs``) the rank's blocks, int8 states quantized by the whole
    leaves' blocks."""
    lasts = _lasts(params, ctx, specs)

    def zeros_like_state(p, last):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return quantize_block(z, last) if cfg.int8_states else z
    device = flatten(params)[0][1].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": tree_map(zeros_like_state, params, lasts),
            "v": tree_map(zeros_like_state, params, lasts)}


def _lasts(params, ctx, specs):
    """Each leaf's ``Blocked`` (None off a mesh), in the params' tree."""
    if specs is None:
        return tree_map(lambda p: None, params)
    return tree_map(lambda p, s: blocked(tuple(p.shape), s, ctx), params,
                    specs)


def global_norm(tree, ctx=None, specs=None) -> torch.Tensor:
    """The f32 norm of the leaves: their sums of squares added in
    ``flatten``'s order; on a mesh (``ctx``, ``specs``) of the whole
    leaves, each block's sum first summed over exactly the axes that
    shard its leaf (one reduction a set of axes, in a fixed order), so
    that on a mesh of one rank the norm is one device's bit for bit."""
    parts = [g.float().square().sum() for _, g in flatten(tree)]
    if specs is not None:
        groups = {}
        for i, (_, spec) in enumerate(flatten(specs)):
            axes = tuple(sorted({a for e in spec for a in _names(e)}))
            if ctx.axes_size(axes) > 1:
                groups.setdefault(axes, []).append(i)
        for axes in sorted(groups):
            idx = groups[axes]
            summed = compat.all_reduce_axis(
                torch.stack([parts[i] for i in idx]), ctx, axes)
            for j, i in enumerate(idx):
                parts[i] = summed[j]
    return torch.sqrt(sum(parts))


_NO_DECAY = ("norm", "ln", "bias", "b_", "mu_", "w0", "u", "scale",
             "A_log", "D", "dt_bias")


def decayable(name: str) -> bool:
    """The reference's ``_decayable`` on a leaf's own name (its last path
    key): no weight decay where the name holds any of ``_NO_DECAY`` as a
    substring. So ``w_up`` and the MoE ``router`` (a ``u``) get none, and
    the QKV biases ``bq``, ``bk``, ``bv`` do get it: the reference's set,
    kept as it is."""
    return not any(s in name for s in _NO_DECAY)


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state, ctx=None,
                  specs=None):
    """One AdamW step, params and state updated in place. ``grads``: the
    params' tree (any float dtype). Returns (params, state, {"lr",
    "grad_norm"}), the norm before clipping. On a mesh (``ctx``, the
    params' ``specs``) the rank's blocks of all three trees."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads, ctx, specs)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()
    consts = (lr, clip, c1, c2)
    for (path, p), (_, g), (_, m), (_, v) in zip(
            flatten(params), flatten(grads), flatten(state["m"]),
            flatten(state["v"])):
        decay = cfg.weight_decay and decayable(str(path[-1]))
        for rows in _row_runs(p):
            _update(cfg, consts, decay, *(_rows(t, rows) for t in (
                p, g, m, v)))
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}


def _row_runs(p: torch.Tensor):
    """Slices of ``p``'s first dim that split it into runs of at most
    ``UPDATE_ROWS_ENTRIES`` entries (one slice, all of it, for a small or
    one-dimensional leaf)."""
    if p.dim() < 2 or p.numel() <= UPDATE_ROWS_ENTRIES:
        return [slice(None)]
    n = max(1, UPDATE_ROWS_ENTRIES // (p.numel() // p.shape[0]))
    return [slice(i, i + n) for i in range(0, p.shape[0], n)]


def _rows(t, rows: slice):
    """A view of rows ``rows`` of a tensor, or of a QTensor's payload and
    scales (its scales keep the payload's leading dims)."""
    if rows == slice(None):
        return t
    if isinstance(t, QTensor):
        q = t.q[rows]
        return QTensor(q=q, scale=t.scale[rows], shape=tuple(q.shape),
                       last=t.last)
    return t[rows]


def _update(cfg: OptimizerConfig, consts, decay: bool, p, g, m, v):
    """AdamW on one leaf (or a run of its rows), in place: ``consts`` the
    step's lr, clip and bias corrections."""
    lr, clip, c1, c2 = consts
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.float() * clip
    if cfg.int8_states:
        m_f = dequantize_block(m)
        v_f = dequantize_block(v).square_()
    else:
        m_f, v_f = m, v
    m_f.mul_(b1).add_((1 - b1) * g)
    v_f.mul_(b2).add_((1 - b2) * g.square_())
    mh = m_f / c1
    if cfg.int8_states:
        uq = quantize_block(torch.sqrt(v_f), v.last)
        denom = dequantize_block(uq) / torch.sqrt(c2) \
            + _quantum_floor(uq) + cfg.eps
        delta = mh.div_(denom)
        mq = quantize_block(m_f, m.last)
        m.q.copy_(mq.q)
        m.scale.copy_(mq.scale)
        v.q.copy_(uq.q)
        v.scale.copy_(uq.scale)
    else:
        delta = mh.div_(torch.sqrt(v_f / c2).add_(cfg.eps))
    if decay:
        delta.add_(cfg.weight_decay * p.float())
    p.copy_(p.float() - lr * delta)
