"""Layers of the LM stack: norms, RoPE, attention, FFN, embeddings.

The port of ``repro.models.layers`` for the transformer families.
Plain functions over dict params, as in the reference, with the weights
in its ``x @ W`` orientation (``[d_in, d_out]``). Params hold one layer
each (the reference stacks layers for ``lax.scan``; the port loops).

Numerics follow the reference: norms and RoPE in f32, cast back to the
activation dtype; biases and norm scales are f32 and cast to the
activation dtype where they are added. Prefill attention is kernel B4
(``kernels/flash_attention.py``), and so is cross-attention onto image
tokens (keys of their own length) in prefill and decode; decode self-
attention, the projections and the FFN are plain PyTorch, as the
reference leaves them to XLA. In training, ``blockwise_attention`` goes
through an autograd Function: B4 forward with its log-sum-exp, and the
reference's ``_flash_b`` backward in plain PyTorch (its Pallas kernel is
forward only, and the reference trains through jnp). The loss is
``softmax_cross_entropy``. The FFN is SwiGLU or, for musicgen, a
two-matrix GELU. The recurrent archs (``rwkv6``, ``mamba2``) share
``silu`` and ``chunk_split``.

On a mesh (``MeshWeights``) a rank holds blocks of the weights, laid out
by ``distributed/sharding.py``, and runs the collectives that the
reference's SPMD partitioner inserts, written out: each weight's
``fsdp``-sharded dim gathered over ``fsdp`` before its use;
column-parallel products where a weight's output dim is over ``model``
and row-parallel ones, summed over ``model``, where its input dim is;
the embedding vocabulary-parallel (a rank looks its range up, writes
zeros elsewhere, and the sum over ``model`` is exact), the unembedding's
logits left sharded over ``model`` on the vocabulary; and decode
attention over a cache whose sequence is sharded (``decode_attention``'s
``seq_axes``): flash-decoding, each rank's softmax over its own keys,
the partial max and sum combined over the axes. The recurrent families
fetch their layers' blocks through it too (``rwkv_time_mix``,
``rwkv_channel_mix``, ``mamba``), their scans on the rank's heads.

In training on a mesh (every family) the same products
carry gradients through ``distributed.compat``'s collectives: each
FSDP gather's backward is a reduce-scatter, each row-parallel sum's the
identity, and where the replicated residual stream enters a
column-parallel product (``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``,
the unembedding) ``MeshWeights.enter`` sums its gradient over
``model``; so do the replicated leaves that a rank uses on its heads
only (the QKV biases and qk-norm scales; rwkv6's ``w0``, ``wB``, ``u``
and ``ln_x``; Mamba's ``A_log``, ``D`` and ``dt_bias``) and, where a
rank's q heads take the replicated k and v, k and v themselves. The
recurrent blocks add their own entries (``rwkv6._time_mix``,
``mamba2.block_apply``). The loss is ``vocab_parallel_nll`` on logits
sharded over ``model``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import draws
from repro_torch.distributed import compat, sharding
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention_gqa


# ---------------------------------------------------------------------------
# initializers
#
# Each init function takes ``keep(path, leaf)``, called on every leaf as
# soon as it is drawn and before the next is, with the leaf's path in the
# tree; what it returns goes into the tree. ``whole`` keeps the leaf;
# ``distributed.sharding.sharded_init`` keeps this rank's block of it.
# ---------------------------------------------------------------------------
def whole(path, leaf):
    return leaf


def under(keep, *prefix):
    """``keep`` for the subtree at ``prefix``."""
    if keep is whole:
        return whole
    return lambda path, leaf: keep(prefix + path, leaf)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, scale: float = 1.0) -> torch.Tensor:
    """Truncated normal at ±3σ, std = scale / sqrt(d_in), drawn in f32 on
    the generator's device, then cast to ``dtype``: ``[d_in, d_out]``."""
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=gen.device)
    if draws(gen):
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w * (scale / math.sqrt(d_in))).to(dtype)


def attn_init(gen: torch.Generator, cfg: ModelConfig,
              cross: bool = False, keep=whole) -> dict:
    """One layer's attention params (biases f32 zeros and qk-norm scales
    f32 ones of ``[head_dim]``, as the reference); a ``cross`` block
    (the VLM's) has no QKV bias."""
    dtype = getattr(torch, cfg.dtype)
    p = {
        "wq": keep(("wq",), dense_init(gen, cfg.d_model, cfg.q_dim, dtype)),
        "wk": keep(("wk",), dense_init(gen, cfg.d_model, cfg.kv_dim, dtype)),
        "wv": keep(("wv",), dense_init(gen, cfg.d_model, cfg.kv_dim, dtype)),
        "wo": keep(("wo",), dense_init(
            gen, cfg.q_dim, cfg.d_model, dtype,
            scale=1.0 / math.sqrt(2 * cfg.n_layers))),
    }
    if cfg.qkv_bias and not cross:
        for name, dim in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                          ("bv", cfg.kv_dim)):
            p[name] = keep((name,), torch.zeros(dim, dtype=torch.float32,
                                                device=gen.device))
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = keep((name,), torch.ones(
                cfg.head_dim, dtype=torch.float32, device=gen.device))
    return p


def ffn_init(gen: torch.Generator, cfg: ModelConfig,
             d_ff: int = 0, keep=whole) -> dict:
    """One layer's FFN params, ``d_ff`` wide (default the config's;
    kimi-k2's leading dense layers take ``d_ff_dense``): SwiGLU's three
    matrices, or ``w_up`` and ``w_down`` where ``ffn_kind`` is
    ``"gelu"``."""
    dtype = getattr(torch, cfg.dtype)
    d_ff = d_ff or cfg.d_ff
    down_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    if cfg.ffn_kind == "gelu":
        return {"w_up": keep(("w_up",),
                             dense_init(gen, cfg.d_model, d_ff, dtype)),
                "w_down": keep(("w_down",), dense_init(
                    gen, d_ff, cfg.d_model, dtype, scale=down_scale))}
    return {
        "w_gate": keep(("w_gate",), dense_init(gen, cfg.d_model, d_ff,
                                               dtype)),
        "w_up": keep(("w_up",), dense_init(gen, cfg.d_model, d_ff, dtype)),
        "w_down": keep(("w_down",), dense_init(gen, d_ff, cfg.d_model, dtype,
                                               scale=down_scale)),
    }


def embed_init(gen: torch.Generator, cfg: ModelConfig, keep=whole) -> dict:
    """Embedding table N(0, 0.02²), and an untied head if the config has
    one."""
    dtype = getattr(torch, cfg.dtype)
    table = torch.empty((cfg.vocab_size, cfg.d_model), dtype=torch.float32,
                        device=gen.device)
    if draws(gen):
        table.normal_(0.0, 1.0, generator=gen)
    p = {"table": keep(("table",), (table * 0.02).to(dtype))}
    del table
    if not cfg.tie_embeddings:
        p["head"] = keep(("head",), dense_init(gen, cfg.d_model,
                                               cfg.vocab_size, dtype))
    return p


# ---------------------------------------------------------------------------
# norm, RoPE
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [S] or [B, S] (integers)."""
    half = x.shape[-1] // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=x.device) / half)
    ang = positions.float()[..., None] * freqs        # [S, half] / [B, S, half]
    ang = ang[None, :, None, :] if positions.dim() == 1 else ang[:, :, None]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """Prefill and training attention, q [B, S, H, hd], k, v [B, Sk, KV,
    hd] -> [B, S, H, hd]; ``window > 0`` keeps only the last ``window``
    positions (gemma3's local layers); Sk != S is cross-attention,
    non-causal, or, causal, a block of query rows at key positions
    ``q_offset`` on over the keys up to its last row (``Sk == q_offset +
    S``): kernel B4 (the reference computes the same function with its
    jnp blockwise attention). Where grad mode is on and q, k or v
    requires grad, through ``Attention`` (B4 with its lse, and
    ``attention_bwd``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return Attention.apply(q, k, v, causal, window, q_offset)
    return flash_attention_gqa(q, k, v, causal=causal, window=window,
                               **_offset(q_offset))


def _offset(q_offset: int) -> dict:
    """B4's ``q_offset`` argument where it is not 0: a call at offset 0 is
    the call it always was, to whatever stands in ``flash_attention_gqa``
    (the checks' fault and site wrappers)."""
    return {"q_offset": q_offset} if q_offset else {}


class Attention(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP (``repro.models.layers``):
    forward B4 with ``return_lse`` (on the CPU its plain version), which
    runs with grad mode off as every Function's forward does; it saves q,
    k, v, the output and the lse, and the backward is ``attention_bwd``.
    Under per-layer remat (``models/rematcfg.py``) the forward runs again
    in the backward pass, B4 included."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset=0):
        out, lse = flash_attention_gqa(q, k, v, causal=causal, window=window,
                                       return_lse=True, **_offset(q_offset))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, lse, dout,
                                   causal=ctx.causal, window=ctx.window,
                                   q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


BWD_BLOCK_K = 512        # keys a backward step, the reference's block_kv


def attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                  window: int = 0, q_offset: int = 0):
    """dq, dk, dv of attention, the reference's ``_flash_b`` in plain
    PyTorch: q, out, dout [B, S, H, hd], k, v [B, Sk, KV, hd], lse f32
    [B, H, S] (the forward's, in scaled-score units). One block of
    ``BWD_BLOCK_K`` keys at a time, in f32: ``delta = Σ dout·out``, ``p =
    exp(s - lse)`` under the forward's mask, ``ds = p·(dp - delta)·
    scale``; dq accumulates over the blocks, dk and dv sum over the G
    query heads of each kv head; each is cast to its input's dtype.
    Query rows that no key of a block can reach (above the diagonal,
    below the window's band) are left out of that block's products: their
    ``p`` is exactly 0 there. Query row i sits at key position
    ``q_offset + i`` (causal; a rank's rows under ``seq_shard_attn``)."""
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(B, S, KV, G, hd).float()
    do = dout.reshape(B, S, KV, G, hd).float()
    delta = (do * out.reshape(B, S, KV, G, hd).float()).sum(-1)
    lse_r = lse.view(B, KV, G, S).permute(0, 3, 1, 2)     # [B, S, KV, G]
    dq = torch.zeros_like(qf)
    dk = torch.empty((B, Sk, KV, hd), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for k0 in range(0, Sk, BWD_BLOCK_K):
        k1 = min(Sk, k0 + BWD_BLOCK_K)
        # the query rows [r0, r1) that see a key of [k0, k1)
        r0 = max(0, k0 - q_offset) if causal else 0
        r1 = min(S, k1 - 1 + window - q_offset) if window > 0 else S
        kb, vb = k[:, k0:k1].float(), v[:, k0:k1].float()
        if r0 >= r1:
            dk[:, k0:k1] = 0.0
            dv[:, k0:k1] = 0.0
            continue
        qb, dob = qf[:, r0:r1], do[:, r0:r1]
        s = torch.einsum("bqkgd,bskd->bqkgs", qb, kb) * scale
        if causal or window > 0:
            d = (torch.arange(q_offset + r0, q_offset + r1,
                              device=q.device)[:, None]
                 - torch.arange(k0, k1, device=q.device)[None, :])
            keep = d >= 0 if causal else torch.ones_like(d, dtype=torch.bool)
            if window > 0:
                keep &= d < window
            s = torch.where(keep[None, :, None, None, :], s, NEG_INF)
        p = torch.exp(s - lse_r[:, r0:r1, ..., None])
        dp = torch.einsum("bqkgd,bskd->bqkgs", dob, vb)
        ds = p * (dp - delta[:, r0:r1, ..., None]) * scale
        dv[:, k0:k1] = torch.einsum("bqkgs,bqkgd->bskd", p, dob)
        dk[:, k0:k1] = torch.einsum("bqkgs,bqkgd->bskd", ds, qb)
        dq[:, r0:r1] += torch.einsum("bqkgs,bskd->bqkgd", ds, kb)
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_index: int, *,
                     window: int = 0, ctx=None, seq_axes=None,
                     seq_start: int = 0) -> torch.Tensor:
    """q: [B, 1, H, hd]; caches: [B, S, KV, hd]; cache entries at
    positions <= cur_index are valid, and with ``window > 0`` only those
    with ``cur_index - pos < window``. Scores and p·v in f32; p / l in
    the cache dtype, as the reference.

    ``seq_axes`` (with ``ctx``): the caches are this rank's block of the
    sequence, from position ``seq_start``, sharded over those mesh axes;
    the max, the sum and p·v are summed over them (flash-decoding), so
    the result is the whole cache's, exact in f32 up to summation
    order."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qh, k_cache.float()) * scale
    pos = torch.arange(seq_start, seq_start + S, device=q.device)
    valid = pos <= cur_index
    if window > 0:
        valid &= cur_index - pos < window
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    if seq_axes:
        m = compat.all_reduce_axis(m, ctx, seq_axes, op="max")
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if seq_axes:
        l = compat.all_reduce_axis(l, ctx, seq_axes)
    out = torch.einsum("bkgs,bskd->bkgd", (p / l).to(v_cache.dtype).float(),
                       v_cache.float())
    if seq_axes:
        out = compat.all_reduce_axis(out, ctx, seq_axes)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def attn_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
             kv_x: Optional[torch.Tensor] = None):
    """Project to q [B, S, H, hd] and k, v [B, Sk, KV, hd] (a rank's
    heads where ``p`` holds its blocks on a mesh), k and v from
    ``kv_x`` [B, Sk, d] where it is given (cross-attention's image
    embeddings), else from x; the f32 biases are added in the activation
    dtype; with qk-norm, q and k are RMS-normalised per head (before
    RoPE, which the caller applies)."""
    src = x if kv_x is None else kv_x
    q, k, v = x @ p["wq"], src @ p["wk"], src @ p["wv"]
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    B, S = x.shape[:2]
    Sk = src.shape[1]
    q = q.reshape(B, S, -1, cfg.head_dim)
    k = k.reshape(B, Sk, -1, cfg.head_dim)
    v = v.reshape(B, Sk, -1, cfg.head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def chunk_split(T: int, chunk: int) -> int:
    """The chunk length of the recurrent scans (rwkv6's WKV, mamba2's
    SSD), min(chunk, T); it must divide T (the reference asserts so; the
    port raises, and never pads)."""
    C = min(chunk, T)
    if C <= 0 or T % C:
        raise ValueError(f"{T} tokens do not split into chunks of {C} "
                         f"(chunk {chunk}); the prompt length must be a "
                         "multiple of the chunk, or shorter than it")
    return C


# ---------------------------------------------------------------------------
# FFN, embedding
# ---------------------------------------------------------------------------
def silu(x: torch.Tensor) -> torch.Tensor:
    """x · 1 / (1 + exp(-x)) with each step rounded to x's dtype: the
    reference's ``jax.nn.silu`` lowers so (torch's fused ``F.silu``
    rounds once, and differs in bf16; ROADMAP C7)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """x · 0.5 (1 + tanh(sqrt(2/π) (x + 0.044715 x³))), the tanh form of
    the reference's ``jax.nn.gelu``, with each step rounded to x's dtype
    and the constants rounded to it first, as JAX casts them (torch's
    fused ``F.gelu(approximate="tanh")`` rounds once, and differs in
    bf16; ROADMAP C7)."""
    c = _GELU_CONSTS[x.dtype]
    inner = c[0] * (x + c[1] * (x * x * x))
    return x * (c[2] * (c[3] + torch.tanh(inner)))


# sqrt(2/π), 0.044715, 0.5 and 1.0 rounded to each dtype, as Python floats
# (exact in f32, so an op with one rounds once, to the tensor's dtype)
_GELU_CONSTS = {dt: tuple(torch.tensor(v, dtype=torch.float64).to(dt).item()
                          for v in (math.sqrt(2.0 / math.pi), 0.044715, 0.5,
                                    1.0))
                for dt in (torch.float32, torch.bfloat16)}


def ffn_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, silu(x W_gate) · (x W_up), then W_down; without
    ``w_gate``, the two-matrix GELU FFN, gelu(x W_up) W_down."""
    if "w_gate" in p:
        return (silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return gelu(x @ p["w_up"]) @ p["w_down"]


def embed_apply(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ (p["head"] if "head" in p else p["table"].T)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, ctx,
                       over) -> torch.Tensor:
    """Each token's NLL, [B, S] f32, of logits [B, S, V_loc] whose
    vocabulary is sharded over the mesh axis ``over`` (the rank's block;
    ``None``: the whole vocabulary), by ``softmax_cross_entropy``'s
    arithmetic: the row max, taken without gradient, is a pmax over
    ``over`` and is subtracted in the logits' dtype; the f32 sum of exps
    is summed over ``over``; the label's shifted logit comes from the
    rank whose block holds it (zeros elsewhere, summed over ``over``).
    The sums' backward is the identity (the loss is replicated over
    ``over``), so each rank's logits get their own columns' gradient."""
    m = logits.detach().amax(dim=-1, keepdim=True)
    lab = labels.long()
    if over is not None:
        m = compat.all_reduce_axis(m, ctx, over, op="max")
    sf = (logits - m).float()
    m0 = m[..., 0].float()
    sumexp = torch.exp(sf).sum(dim=-1)
    if over is None:
        picked = sf.gather(-1, lab[..., None])[..., 0]
    else:
        n = logits.shape[-1]
        ids = lab - ctx.block(n * ctx.axes_size(over), over).start
        inside = (ids >= 0) & (ids < n)
        picked = sf.gather(-1, ids.clamp(0, n - 1)[..., None])[..., 0]
        picked = torch.where(inside, picked, torch.zeros((), device=sf.device))
        sumexp = compat.all_reduce_axis(sumexp, ctx, over)
        picked = compat.all_reduce_axis(picked, ctx, over)
    return (torch.log(sumexp) + m0) - (picked + m0)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``mask``-weighted token NLL, as the reference's: logits
    [B, S, V] in the model's dtype, labels [B, S] integers, mask [B, S]
    f32. The max is taken without gradient and subtracted in the logits'
    dtype; exp and the sum over V in f32. The label's log-probability is
    a gather where the reference contracts with a one-hot (for its
    vocab-sharded mesh): on one card the two are the same numbers, values
    and gradients, bit for bit (every other term of the contraction is
    ±0; tests/test_torch_train.py holds them so)."""
    m = logits.detach().amax(dim=-1, keepdim=True)
    shifted = logits - m
    sf = shifted.float()
    m0 = m[..., 0].float()
    lse = torch.log(torch.exp(sf).sum(dim=-1)) + m0
    ll = sf.gather(-1, labels.long()[..., None])[..., 0] + m0
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# on a mesh
# ---------------------------------------------------------------------------
class MeshWeights:
    """A forward's view of the rank's weight blocks on ``ctx``'s mesh.

    ``weight`` takes a block, with its path's last names and the leaf's
    whole shape, and returns it with its ``fsdp`` dims gathered, and its
    spec (``sharding.leaf_spec``). ``attn`` and ``ffn`` hand such
    weights to ``attn_qkv`` and ``ffn_apply``, the one-device functions;
    ``rwkv_time_mix``, ``rwkv_channel_mix`` and ``mamba`` to the
    recurrent blocks; ``row_sum`` then sums a row-parallel product over
    ``model``.

    ``sp`` (the forward sets it, ``perfcfg``'s ``sp_residual``; and
    ``seq_attn``, its ``seq_shard_attn``, ``models/transformer.py``): the
    residual stream is the rank's block of the sequence's rows
    (``rows``), not the whole sequence replicated over ``model``: the
    vocabulary-parallel embedding ends in a reduce-scatter over the rows,
    each column-parallel entry gathers them (``enter_rows``), each
    row-parallel exit reduce-scatters them (``row_sum``), and the final
    norm takes them whole again (``enter_rows`` for replicated work)."""

    def __init__(self, cfg: ModelConfig, ctx, local_batch: bool = False):
        self.cfg, self.ctx = cfg, ctx
        self.tp = ctx.tp_axis
        self.r = ctx.coord(ctx.tp_axis)
        self.table = None
        self.local_batch = local_batch
        self.sp = False
        self.seq_attn = False       # perfcfg's seq_shard_attn: the forward's

    def rows(self, S: int) -> slice:
        """The rank's block of ``S`` sequence rows over ``model``."""
        return self.ctx.block(S, self.tp)

    def enter_rows(self, x: torch.Tensor, over) -> torch.Tensor:
        """The residual stream ``x`` where it enters a column-parallel
        product (``over``: the spec entry of the product's split dim):
        ``enter``, or under ``sp`` its rows gathered whole over ``model``,
        whose backward sums the parts' gradients where the product is
        split there (``compat.gather_parts_axis``) and keeps the rank's
        rows where it is not (``compat.all_gather_axis``: the replicated
        work downstream enters "f" itself)."""
        if not self.sp:
            return self.enter(x, over)
        if over == self.tp:
            return compat.gather_parts_axis(x, self.ctx, self.tp, 1)
        return compat.all_gather_axis(x, self.ctx, self.tp, 1)

    def row_scale(self, scale: torch.Tensor) -> torch.Tensor:
        """A per-token norm's replicated ``scale``: under ``sp`` each rank
        applies it to its own rows, so it enters "f" (its gradients are
        parts, summed over ``model``)."""
        return self.enter(scale, self.tp) if self.sp else scale

    def enter(self, x: torch.Tensor, over) -> torch.Tensor:
        """``x``, replicated over ``model``, where it enters work split
        there (``over``: the spec entry of the split dim; anything else
        than ``model`` leaves ``x`` as it is): the backward sums the
        ranks' gradients over ``model`` (``compat.to_parallel``)."""
        if over != self.tp:
            return x
        return compat.to_parallel(x, self.ctx, self.tp)

    def attn_entries(self):
        """The spec entries of ``wq``'s and ``wk``'s output dims: the
        q heads and the kv heads are over ``model`` where they are
        ``model``."""
        cfg, d = self.cfg, self.cfg.d_model
        return (sharding.leaf_spec(("attn", "wq"), (d, cfg.q_dim), cfg,
                                   self.ctx, True)[1],
                sharding.leaf_spec(("attn", "wk"), (d, cfg.kv_dim), cfg,
                                   self.ctx, True)[1])

    def weight(self, t, names, full, stacked: bool = True):
        spec = sharding.leaf_spec(names, full, self.cfg, self.ctx, stacked)
        return sharding.gather(t, spec, self.ctx), spec

    def row_sum(self, y: torch.Tensor, over) -> torch.Tensor:
        """y summed over ``model`` where the product's input dim was
        sharded there (``over``: that dim's spec entry). The partial
        products, each rounded to y's dtype, are summed in f32 and the
        sum rounded once, as the reference's partitioner promotes a bf16
        all-reduce to f32 (read from its compiled HLO: a bf16 convert,
        then an f32 all-reduce, at the transformers' ``wo`` and
        ``w_down``, rwkv6's ``tm.wo`` and ``cm.wv`` and Mamba's
        ``out_proj``). Under ``sp`` the sum is a reduce-scatter over the
        rows, in f32 and rounded once alike."""
        if over == self.tp and self.sp:
            return compat.reduce_scatter_axis(y, self.ctx, self.tp, 1)
        if over == self.tp:
            return compat.all_reduce_axis(y.float(), self.ctx,
                                          self.tp).to(y.dtype)
        return y

    def attn(self, ap: dict, names=("wq", "wk", "wv", "wo")):
        """(one layer's attention weights for the rank: ``names`` of
        ``wq``, ``wk``, ``wv`` and ``wo`` gathered over ``fsdp``, the
        biases cut to the rank's heads; ``wo``'s input dim's spec entry,
        for ``row_sum``, or None without ``wo``)."""
        cfg, d = self.cfg, self.cfg.d_model
        full = {"wq": (d, cfg.q_dim), "wk": (d, cfg.kv_dim),
                "wv": (d, cfg.kv_dim), "wo": (cfg.q_dim, d)}
        out, specs = dict(ap), {}
        for name in names:
            out[name], specs[name] = self.weight(ap[name], ("attn", name),
                                                 full[name])
        # replicated leaves that the rank uses on its own heads: their
        # gradients are summed over model (``enter``)
        if "bq" in ap:
            qo, ko = specs["wq"][1], specs["wk"][1]
            out["bq"] = self.enter(ap["bq"], qo)[self.ctx.block(cfg.q_dim,
                                                                 qo)]
            out["bk"] = self.enter(ap["bk"], ko)[self.ctx.block(cfg.kv_dim,
                                                                 ko)]
            out["bv"] = self.enter(ap["bv"], ko)[self.ctx.block(cfg.kv_dim,
                                                                 ko)]
        for norm, w in (("q_norm", "wq"), ("k_norm", "wk")):
            if norm in ap and w in specs:
                out[norm] = self.enter(ap[norm], specs[w][1])
        return out, specs["wo"][0] if "wo" in specs else None

    def ffn(self, p: dict, x: torch.Tensor, parent: str,
            d_ff: int) -> torch.Tensor:
        """``ffn_apply`` on ``parent``'s blocks (``d_ff`` wide whole),
        gathered over ``fsdp``: column-parallel ``w_gate`` and ``w_up``,
        row-parallel ``w_down`` summed over ``model``. Under ``sp`` an FFN
        replicated over ``model`` (``d_ff`` does not divide it) runs on
        the rank's rows alone (it is a function of each row), its weights
        entering "f": each rank's gradients of them are parts."""
        d = self.cfg.d_model
        w = {}
        w["w_up"], su = self.weight(p["w_up"], (parent, "w_up"), (d, d_ff))
        w["w_down"], sd = self.weight(p["w_down"], (parent, "w_down"),
                                      (d_ff, d))
        if "w_gate" in p:
            w["w_gate"], _ = self.weight(p["w_gate"], (parent, "w_gate"),
                                         (d, d_ff))
        if self.sp and su[1] != self.tp:
            return ffn_apply({k: self.enter(t, self.tp)
                              for k, t in w.items()}, x)
        return self.row_sum(ffn_apply(w, self.enter_rows(x, su[1])), sd[0])

    def batch_block(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's block of ``t``'s batch (dim 0) over ``dp_axes``
        where it divides (``MeshCtx.batch_sharded``), else ``t``; ``t``
        itself where the batch is the rank's block already
        (``local_batch``: training, ``data.pipeline.shard_batch``)."""
        if self.local_batch:
            return t
        B = t.shape[0]
        return t[self.ctx.block(B, self.ctx.dp_axes)] \
            if self.ctx.batch_sharded(B) else t

    def gather_tp(self, t: torch.Tensor, over) -> torch.Tensor:
        """``t`` gathered over ``model`` along its last dim where that dim
        is sharded there (``over``: its spec entry), else ``t``."""
        if over != self.tp:
            return t
        return compat.all_gather_axis(t, self.ctx, self.tp, t.dim() - 1)

    def embed(self, p: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The rank's batch block of ``tokens`` [B, S] (over ``dp_axes``
        where B divides) looked up vocabulary-parallel: the rank's range
        of the table, gathered over ``fsdp`` (kept for a tied
        ``unembed``), zeros for the others' ids, summed over ``model``
        (exact); under ``sp`` the sum is a reduce-scatter over the rows,
        and a table replicated over ``model`` is looked up at the rank's
        rows, entering "f"."""
        cfg, ctx = self.cfg, self.ctx
        tokens = self.batch_block(tokens)
        self.table, spec = self.weight(p["table"], ("embed", "table"),
                                       (cfg.vocab_size, cfg.d_model),
                                       stacked=False)
        table = self.table
        if spec[0] != self.tp and self.sp:
            return self.enter(table, self.tp)[
                tokens[:, self.rows(tokens.shape[1])]]
        if spec[0] != self.tp:
            return table[tokens]
        rows = table.shape[0]
        ids = tokens.long() - self.r * rows
        inside = (ids >= 0) & (ids < rows)
        x = torch.where(inside[..., None], table[ids.clamp(0, rows - 1)],
                        torch.zeros((), dtype=table.dtype,
                                    device=table.device))
        if self.sp:
            return compat.reduce_scatter_axis(x, ctx, self.tp, 1)
        return compat.all_reduce_axis(x, ctx, self.tp)

    def unembed(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """The rank's logits [..., V/M] (its vocabulary block where the
        head's V is over ``model``, else all V); a tied head is the table
        ``embed`` gathered."""
        cfg = self.cfg
        if "head" not in p:
            spec = sharding.leaf_spec(("embed", "table"),
                                      (cfg.vocab_size, cfg.d_model), cfg,
                                      self.ctx)
            return self.enter(x, spec[0]) @ self.table.T
        head, spec = self.weight(p["head"], ("embed", "head"),
                                 (cfg.d_model, cfg.vocab_size), stacked=False)
        return self.enter(x, spec[1]) @ head

    # -- the recurrent families --------------------------------------------
    def heads(self, n: int, what: str) -> slice:
        """The rank's block of ``n`` heads over ``model``; a
        ``ValueError`` where they do not divide it."""
        ts = self.ctx.tp_size
        if n % ts:
            raise ValueError(f"{self.cfg.name}: {n} {what} heads do not "
                             f"divide the model axis of {ts}; its state "
                             "shards its heads there (cache_specs)")
        return self.ctx.block(n, self.tp)

    def rwkv_time_mix(self, p: dict):
        """(rwkv6's time-mix weights for the rank's heads, ``wo``'s input
        dim's entry for ``row_sum``): ``wr``, ``wk``, ``wv`` and ``wg``
        column-parallel and ``wo`` row-parallel, each gathered over
        ``fsdp`` (``leaf_spec`` lays a column block on whole heads where
        the heads divide ``model``); of the replicated leaves, ``w0``,
        ``wB``'s columns, ``u`` and ``ln_x`` cut to the rank's heads (a
        decay column needs only its own column of ``wB``), the lerp
        coefficients and ``wA`` whole. The cut leaves enter through "f"
        (``enter``) first, so that their gradients are summed over
        ``model``."""
        cfg, d = self.cfg, self.cfg.d_model
        hd = cfg.rwkv_head_size
        heads = self.heads(d // hd, "WKV")
        ch = slice(heads.start * hd, heads.stop * hd)
        out = dict(p)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            out[name], spec = self.weight(p[name], ("tm", name), (d, d))
        own = {name: self.enter(p[name], self.tp)
               for name in ("w0", "wB", "u", "ln_x")}
        out.update(w0=own["w0"][ch], wB=own["wB"][:, ch],
                   u=own["u"][heads], ln_x=own["ln_x"][ch])
        return out, spec[0]

    def rwkv_channel_mix(self, p: dict):
        """(rwkv6's channel-mix weights for the rank, the spec entries of
        ``wr``'s and ``wk``'s output dims and ``cm.wv``'s input dim):
        ``wr`` and ``wk`` column-parallel, ``wv`` row-parallel, each
        gathered over ``fsdp``; ``mu_r`` and ``mu_k`` whole."""
        cfg, d = self.cfg, self.cfg.d_model
        out = dict(p)
        out["wr"], sr = self.weight(p["wr"], ("cm", "wr"), (d, d))
        out["wk"], sk = self.weight(p["wk"], ("cm", "wk"), (d, cfg.d_ff))
        out["wv"], sv = self.weight(p["wv"], ("cm", "wv"), (cfg.d_ff, d))
        return out, sr[1], sk[1], sv[0]

    def mamba(self, p: dict):
        """(a Mamba-2 layer's weights for the rank, its heads, the spec
        entry of ``out_proj``'s input dim): ``in_proj`` gathered over
        ``fsdp`` and whole on every ``model`` rank (its fused sections
        are not TP-aligned), ``conv_w`` and the norms whole; ``A_log``,
        ``D`` and ``dt_bias`` cut to the rank's heads (over ``model``,
        as ``cache_specs`` lays the state out), each through "f"
        (``enter``) first; ``out_proj``'s rows gathered over
        ``fsdp``."""
        cfg, d = self.cfg, self.cfg.d_model
        d_in, N = cfg.d_inner, cfg.ssm_state
        nh = d_in // cfg.ssm_headdim
        heads = self.heads(nh, "SSD")
        out = dict(p)
        out["in_proj"], _ = self.weight(p["in_proj"], ("mamba", "in_proj"),
                                        (d, 2 * d_in + 2 * N + nh))
        out["out_proj"], so = self.weight(p["out_proj"],
                                          ("mamba", "out_proj"), (d_in, d))
        for name in ("A_log", "D", "dt_bias"):
            out[name] = self.enter(p[name], self.tp)[heads]
        return out, heads, so[0]
