"""Decoder-only transformer, the dense, MoE, VLM and audio families: the
port of ``repro.models.transformer`` (qwen2, qwen3, internlm2,
qwen3-moe, gemma3, kimi-k2, llama-3.2-vision, musicgen).

GQA attention with RoPE, optional QKV bias and qk-norm, a SwiGLU or
two-matrix GELU FFN (musicgen) or an MoE block (``models/moe.py``) in
every layer, RMS norms, tied or untied unembedding. A layer's attention
is global or, where the config has a sliding window, local to the last
``window`` positions as ``window_schedule`` says (gemma3: five local
layers to one global).
An MoE config with ``first_k_dense`` (kimi-k2) leads with that many
dense layers of FFN width ``d_ff_dense`` (the reference's
``dense_blocks``, ahead of its ``moe_blocks``). Prefill runs every
layer's attention through kernel B4; decode writes the new position into
a preallocated cache in place and attends over the positions ``<=
cur_index`` (within the window on a local layer). Local layers keep a
cache of ``max_len`` positions, as the reference's do.

The VLM (llama-3.2-vision) runs superblocks of ``cross_attn_every``
self-attention layers, then one cross-attention layer onto the image
tokens: non-causal B4 over k and v projected from
``batch["image_embeds"]`` once a prefill (``_image_kv``, no RoPE), then
the cross layer's own FFN. Its decode cache carries those k and v
(``img_k``, ``img_v``), and each decode step runs B4 once a cross layer
at one query. The audio arch (musicgen) takes ``batch["embeds"]`` (frame
embeddings from its stub frontend) in place of tokens where it is given.

Training (``mode="train"``) runs the prefill's forward without
collecting k and v, each layer (and each VLM cross layer) under the
remat policy ``remat`` names (``models/rematcfg.py``: per-layer
``torch.utils.checkpoint``), and returns the MoE layers' summed aux; its
attention is ``layers.blockwise_attention``'s autograd Function.

``forward(..., ctx=None)``: without a ctx, or on a ``single_device_ctx``
(no DeviceMesh), it runs on one device. On a ctx with a DeviceMesh
(every family here, prefill and decode) the same layer loop runs
the rank's blocks of the weights (``distributed/sharding.py``), fetched
through a ``layers.MeshWeights`` (gathered over ``fsdp``) and handed to
the one-device ``attn_qkv`` and ``ffn_apply``, on its block of the
batch, as the reference's constraints lay them out
(``src/repro/models/transformer.py:180-208, 296``): the batch over
``dp_axes`` where it divides, the residual stream replicated over
``model``; q heads over ``model`` where they divide, kv heads where
they do, and B4 on the rank's heads (a rank whose q heads share kv
heads it does not hold takes those from the replicated k and v); the
FFN column- then row-parallel, the row-parallel products summed over
``model``; the MoE's dispatch over ``model`` (``models/moe.py``); the
logits left sharded over ``model`` on the vocabulary. Decode writes and
attends over the rank's block of the cache as
``serve.step.cache_specs`` lays it out: kv heads over ``model``, or the
sequence there (flash-decoding) where they do not divide. The audio
arch's frame embeddings are cut to the rank's batch block as tokens
are. The VLM's image embeddings too; its cross layers take ``wk`` and
``wv`` as the self layers do (the rank's kv heads, or every kv head),
B4 on the rank's q heads, and ``wo`` and the FFN through
``MeshWeights``; its image cache is laid out as the self cache, and
where that shards the image positions a decode step's cross attention
is flash-decoding over them.

Training on a mesh (``mode="train"`` with a ctx; the dense and MoE
families) runs the same layer loop, each layer under the remat policy,
on the rank's block of the batch (``data.pipeline.shard_batch``: the
caller cuts it, as the reference's ``shard_batch`` places it), with
the gradients carried through ``distributed.compat``'s collectives
(``layers.MeshWeights``): the recompute of a layer repeats its FSDP
gathers and its B4 launch on the rank's heads. The logits come out
sharded over ``model`` on the vocabulary, for
``layers.vocab_parallel_nll``. Every family trains so: the VLM's cross
layers run under the remat policy too, q and the image k and v entering
the rank's heads through "f" (``MeshWeights.enter``), and musicgen's
frame embeddings come in as the rank's rows.

The reference's perf flags (``models/perfcfg``), each under the
reference's own conditions, on a mesh (the dense, MoE and audio
families; the VLM's layers take neither, as the reference's do not):

  - ``seq_shard_attn`` (train and prefill, where the q heads do not
    divide ``model``, S divides it and S >= 1024): in place of every
    rank computing every head for every row, rank r attends for its
    rows ``[r·S/M, (r+1)·S/M)`` over the keys ``[0, (r+1)·S/M)``, B4
    at ``q_offset = r·S/M``, and its rows after ``wo`` are gathered
    over ``model`` along the sequence. q, k, v and ``wo``, replicated
    there, enter "f": each rank's gradients of them are parts;
  - ``sp_residual`` (where S divides ``model`` and S >= M): the residual
    stream is the rank's rows between blocks (``layers.MeshWeights``'
    ``sp``): the norms and residual adds run on them, each
    column-parallel entry gathers the rows, each row-parallel exit
    reduce-scatters them, the MoE dispatches its rows as they are, and
    the final norm takes the rows whole. Attention replicated over
    ``model`` computes every row and keeps the rank's (its q, k, v and
    ``wo`` entering "f"), or, with ``seq_shard_attn``, the rank's rows
    alone. As in the reference, gemma3 under ``banded_local`` keeps its
    residual whole (its superblock scan has no such constraint);
  - ``banded_local`` changes no work: B4's windowed instance starts each
    query tile's key loop at the band's first tile, which is the O(S·w)
    that the reference's banded attention buys (ROADMAP C29);
  - ``a2a_int8`` and ``router_bf16_matmul`` act in the MoE block
    (``models/moe.py``), on one device too.

Logit-softcap configs raise ``NotImplementedError`` (no config of the
repo sets one).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed import compat
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import perfcfg, rematcfg

MODES = ("prefill", "decode", "train")
FAMILIES = ("dense", "moe", "vlm", "audio")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this module does not run:
    a logit softcap, and families other than ``FAMILIES``
    (``models/model.py`` sends ``ssm`` and ``hybrid`` configs to
    ``rwkv6`` and ``hybrid``, never here)."""
    missing = [name for name, off in (
        (f"family {cfg.family!r}", cfg.family in FAMILIES),
        ("logit softcap", cfg.attn_logit_softcap == 0.0)) if not off]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
                keep=L.whole) -> dict:
    """One layer of ``kind``: ``"moe"`` (the reference's ``moe_blocks``),
    ``"dense_lead"`` (its ``dense_blocks``: an ``"mlp"`` of width
    ``d_ff_dense``), ``"cross"`` (the VLM's ``cross_blocks``: attention
    without QKV bias) or ``"dense"``."""
    d = cfg.d_model
    p = {"ln1": keep(("ln1",), torch.ones(d, dtype=torch.float32,
                                          device=gen.device)),
         "attn": L.attn_init(gen, cfg, cross=kind == "cross",
                             keep=L.under(keep, "attn")),
         "ln2": keep(("ln2",), torch.ones(d, dtype=torch.float32,
                                          device=gen.device))}
    if kind == "moe":
        p["moe"] = moe_lib.moe_init(gen, cfg, keep=L.under(keep, "moe"))
    else:
        p["mlp"] = L.ffn_init(gen, cfg, cfg.d_ff_dense
                              if kind == "dense_lead" else 0,
                              keep=L.under(keep, "mlp"))
    return p


def n_superblocks(cfg: ModelConfig) -> int:
    """The VLM's superblocks: ``cross_attn_every`` self layers and one
    cross layer each (0 for the other families)."""
    return cfg.n_layers // cfg.cross_attn_every if cfg.family == "vlm" \
        else 0


def layer_kinds(cfg: ModelConfig) -> list:
    """Each self-attention layer's kind in order: with experts,
    ``first_k_dense`` ``"dense_lead"`` layers and then ``"moe"``, else
    ``"dense"`` (the VLM's whole superblocks' worth)."""
    if cfg.family == "vlm":
        return ["dense"] * (n_superblocks(cfg) * cfg.cross_attn_every)
    if cfg.n_experts > 0:
        nd = cfg.first_k_dense
        return ["dense_lead"] * nd + ["moe"] * (cfg.n_layers - nd)
    return ["dense"] * cfg.n_layers


def window_schedule(cfg: ModelConfig, n: int) -> list:
    """Each of ``n`` layers' sliding window (0 = global), as the
    reference's: with ``local_global_ratio`` r, layer i is global iff
    ``i % (r + 1) == r`` (gemma3: five local to one global)."""
    if cfg.local_global_ratio > 0 and cfg.sliding_window > 0:
        per = cfg.local_global_ratio + 1
        return [cfg.sliding_window if i % per != per - 1 else 0
                for i in range(n)]
    if cfg.sliding_window > 0:
        return [cfg.sliding_window] * n
    return [0] * n


def init(gen: torch.Generator, cfg: ModelConfig, keep=L.whole) -> dict:
    """Random params on the generator's device: ``{"embed", "final_norm",
    "blocks": [one dict a layer]}``, the layers in ``layer_kinds``'
    order; the VLM adds ``"cross_blocks"``, one a superblock. ``keep``:
    see ``layers.whole``."""
    check_supported(cfg)
    p = {"embed": L.embed_init(gen, cfg, keep=L.under(keep, "embed")),
         "final_norm": keep(("final_norm",), torch.ones(
             cfg.d_model, dtype=torch.float32, device=gen.device)),
         "blocks": [_block_init(gen, cfg, kind, L.under(keep, "blocks", i))
                    for i, kind in enumerate(layer_kinds(cfg))]}
    if cfg.family == "vlm":
        p["cross_blocks"] = [
            _block_init(gen, cfg, "cross", L.under(keep, "cross_blocks", i))
            for i in range(n_superblocks(cfg))]
    return p


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------
def _self_attn(pb, x, cfg, *, positions, window, mode, cache=None,
               cur_index=None, mw=None, layout=None):
    """Returns (attn_out, (k, v)): the rotated k and v of this call in
    prefill and train, the updated caches in decode. ``window``: the
    layer's (0 = global). On a mesh (``mw``, the forward's
    ``layers.MeshWeights``) the rank's heads, its output summed over
    ``model`` where ``wo`` is row-parallel, and in decode the rank's
    cache blocks, written at ``cur_index`` where it falls in their
    block; ``layout``: the decode cache's (sequence axes, the block's
    first position, kv heads over ``model``), ``_cache_layout``'s.

    Under ``mw.sp`` x is the rank's rows, and so is the result; where
    ``mw.seq_attn`` the rank attends for its rows alone (B4 at a query
    offset). Either way, attention replicated over ``model`` takes q, k,
    v and ``wo`` through "f" (each rank's gradients of them are
    parts)."""
    ap, wo_over = (pb["attn"], None) if mw is None else mw.attn(pb["attn"])
    h = L.rms_norm(x, pb["ln1"] if mw is None else mw.row_scale(pb["ln1"]),
                   cfg.norm_eps)
    parts = False       # replicated attention, each rank's rows a part
    if mw is None:
        q, k, v = L.attn_qkv(ap, h, cfg)
    else:           # the column-parallel entries (``MeshWeights.enter``)
        q_over, kv_over = mw.attn_entries()
        hq = mw.enter_rows(h, q_over)
        q, k, v = L.attn_qkv(ap, hq, cfg, kv_x=None if kv_over == q_over
                             else mw.enter_rows(h, kv_over))
        parts = mode != "decode" and q_over != mw.tp and (mw.sp
                                                         or mw.seq_attn)
    q = L.rope(q, positions, cfg.rope_theta)
    k_rot = L.rope(k, positions, cfg.rope_theta)
    if parts:
        q, k_rot, v = (mw.enter(t, mw.tp) for t in (q, k_rot, v))
        ap = dict(ap, wo=mw.enter(ap["wo"], mw.tp))
    Hl = q.shape[2]
    # a rank's q heads [h0, h0 + Hl) where they shard and kv heads do not
    kv_whole = Hl < cfg.n_heads and k.shape[2] == cfg.n_kv_heads
    h0 = mw.r * Hl if Hl < cfg.n_heads else 0
    if mode != "decode" and parts and mw.seq_attn:
        # the rank's rows [a, b) over the keys [0, b)
        rows = mw.rows(q.shape[1])
        a, b = rows.start, rows.stop
        out = L.blockwise_attention(q[:, a:b], k_rot[:, :b], v[:, :b],
                                    causal=True, window=window, q_offset=a)
        new_kv = (k_rot, v)
    elif mode != "decode":
        # every kv head on each rank, each rank's q heads meet some: the
        # ranks' gradients of k and v are parts, summed over model
        kq, vq = _kv_for_heads(mw.enter(k_rot, mw.tp), mw.enter(v, mw.tp),
                               h0, Hl, cfg) if kv_whole else (k_rot, v)
        out = L.blockwise_attention(q, kq, vq, causal=True, window=window)
        new_kv = (k_rot, v)
    else:           # decode: cache = (k_cache, v_cache) [B, S_max, KV, hd]
        k_cache, v_cache = cache
        seq_axes, seq_start = layout or ((), 0)
        at = cur_index - seq_start
        if mw is None or 0 <= at < k_cache.shape[1]:
            k_cache[:, at] = k_rot[:, 0]
            v_cache[:, at] = v[:, 0]
        ctx = None if mw is None else mw.ctx
        if kv_whole:    # every kv head here: every q head, then ours
            q = compat.all_gather_axis(q, ctx, mw.tp, dim=2)
        out = L.decode_attention(q, k_cache, v_cache, cur_index,
                                 window=window, ctx=ctx, seq_axes=seq_axes,
                                 seq_start=seq_start)
        if kv_whole:
            out = out[:, :, h0:h0 + Hl]
        new_kv = (k_cache, v_cache)
    B, S = out.shape[:2]
    y = out.reshape(B, S, Hl * cfg.head_dim) @ ap["wo"]
    if not parts:
        return (y if mw is None else mw.row_sum(y, wo_over)), new_kv
    if mw.seq_attn and not mw.sp:   # the rows, whole over model
        return compat.all_gather_axis(y, mw.ctx, mw.tp, dim=1), new_kv
    return (y if mw.seq_attn else y[:, mw.rows(S)]), new_kv


def _image_kv(cross_blocks, image_embeds, cfg, mw=None):
    """Each cross layer's k and v from the image embeddings [B, n_img, d]:
    stacked ``[n_cross, B, n_img, KV, hd]``, no RoPE; k RMS-normed where
    the block has ``k_norm``. The projection promotes as the reference's
    jnp ``@`` does: f32 embeddings give f32 k and v in a bf16 model. On a
    mesh (``mw``) ``wk`` and ``wv`` are the rank's, gathered over
    ``fsdp``: its kv heads where they divide ``model``, else every kv
    head; the embeddings enter them through "f"."""
    B, n_img = image_embeds.shape[:2]
    ks, vs = [], []
    for pb in cross_blocks:
        if mw is None:
            ap, x = pb["attn"], image_embeds
        else:
            ap = mw.attn(pb["attn"], ("wk", "wv"))[0]
            x = mw.enter(image_embeds, mw.attn_entries()[1])
        dt = torch.promote_types(x.dtype, ap["wk"].dtype)
        x = x.to(dt)
        k = (x @ ap["wk"].to(dt)).reshape(B, n_img, -1, cfg.head_dim)
        v = (x @ ap["wv"].to(dt)).reshape(B, n_img, -1, cfg.head_dim)
        if "k_norm" in ap:
            k = L.rms_norm(k, ap["k_norm"], cfg.norm_eps)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def _cross_attn(pb, x, img_kv, cfg, mw=None, layout=None):
    """x + the cross layer onto the image k and v [B, n_img, KV, hd]
    (non-causal B4 at Sk = n_img, then ``wo``), then + its FFN. Where k
    and v are f32 beside a bf16 q (f32 image embeddings), q is upcast,
    which is exact, and the output cast back to q's dtype: the
    reference's attention promotes so.

    On a mesh (``mw``): q on the rank's heads (the normed x entering
    ``wq`` through "f"), B4 over the kv heads they meet
    (``_kv_for_heads`` where the rank holds every kv head, k and v
    entering through "f", as the self layers' do), ``wo`` row-parallel
    and the FFN through ``mw.ffn``. ``layout`` (decode):
    the image cache's (sequence axes, the block's first position); where
    the sequence is sharded (kv heads that do not divide ``model``, or a
    batch that does not divide the dp axes), the rank holds a block of
    the image positions and the attention is flash-decoding over them,
    ``layers.decode_attention(seq_axes=)`` with every position valid."""
    ap, wo_over = (pb["attn"], None) if mw is None else \
        mw.attn(pb["attn"], ("wq", "wo"))
    B, S = x.shape[:2]
    h = L.rms_norm(x, pb["ln1"], cfg.norm_eps)
    if mw is not None:
        h = mw.enter(h, mw.attn_entries()[0])
    q = (h @ ap["wq"]).reshape(B, S, -1, cfg.head_dim)
    if "q_norm" in ap:
        q = L.rms_norm(q, ap["q_norm"], cfg.norm_eps)
    k, v = img_kv
    Hl = q.shape[2]
    kv_whole = Hl < cfg.n_heads and k.shape[2] == cfg.n_kv_heads
    h0 = mw.r * Hl if Hl < cfg.n_heads else 0
    seq_axes, seq_start = layout or ((), 0)
    if seq_axes:
        qa = compat.all_gather_axis(q, mw.ctx, mw.tp, dim=2) if kv_whole \
            else q
        out = L.decode_attention(qa.to(k.dtype), k, v, cfg.n_image_tokens - 1,
                                 ctx=mw.ctx, seq_axes=seq_axes,
                                 seq_start=seq_start)
        out = (out[:, :, h0:h0 + Hl] if kv_whole else out).to(q.dtype)
    else:
        kq, vq = _kv_for_heads(mw.enter(k, mw.tp), mw.enter(v, mw.tp),
                               h0, Hl, cfg) if kv_whole else (k, v)
        out = L.blockwise_attention(q.to(k.dtype), kq, vq,
                                    causal=False).to(q.dtype)
    y = out.reshape(B, S, Hl * cfg.head_dim) @ ap["wo"]
    x = x + (y if mw is None else mw.row_sum(y, wo_over))
    h = L.rms_norm(x, pb["ln2"], cfg.norm_eps)
    return x + (L.ffn_apply(pb["mlp"], h) if mw is None
                else mw.ffn(pb["mlp"], h, "mlp", cfg.d_ff))


def _mlp_or_moe(pb, x, cfg, mw=None, d_ff=0):
    """(x + FFN or MoE of the normed x, the layer's f32 aux or None). On a
    mesh (``mw``) the FFN ``d_ff`` wide whole, column- then
    row-parallel, and the MoE's dispatch over ``model``."""
    h = L.rms_norm(x, pb["ln2"] if mw is None else mw.row_scale(pb["ln2"]),
                   cfg.norm_eps)
    if "moe" in pb:
        y, aux = moe_lib.moe_apply(pb["moe"], h, cfg, mw)
        return x + y, aux
    y = L.ffn_apply(pb["mlp"], h) if mw is None \
        else mw.ffn(pb["mlp"], h, "mlp", d_ff)
    return x + y, None


def _train_layer(pb, x, cfg, positions, window, mw=None, d_ff=0):
    """One self-attention layer of a training forward: (x, its aux or
    None); on a mesh (``mw``) the FFN ``d_ff`` wide whole."""
    attn_out, _ = _self_attn(pb, x, cfg, positions=positions, window=window,
                             mode="train", mw=mw)
    return _mlp_or_moe(pb, x + attn_out, cfg, mw, d_ff)


# ---------------------------------------------------------------------------
# forward: prefill / decode / train
# ---------------------------------------------------------------------------
def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            mode: str = "prefill", caches: Optional[dict] = None,
            cur_index: Optional[int] = None, last_only: bool = False,
            remat=True, ctx=None):
    """batch: ``{"tokens": [B, S]}`` (``S == 1`` in decode), or with
    ``cfg.embeds_input`` ``{"embeds": [B, S, d]}``; the VLM's prefill
    also takes ``"image_embeds"`` [B, n_image_tokens, d]. Returns
    (logits, aux, kv): ``aux`` is the f32 scalar sum of the MoE layers'
    load-balancing losses (0 without experts); in prefill ``kv`` stacks
    every self layer's rotated k and v, ``[n_layers, B, S, KV, hd]``, and
    for the VLM each cross layer's image k and v as ``img_k`` and
    ``img_v``, ``[n_cross, B, n_img, KV, hd]``; in decode it is
    ``caches``, updated in place at ``cur_index``; in train it is
    ``None``. ``last_only`` unembeds only the last position (its logits
    are the same). ``remat`` (train only): ``True`` (the default
    policy), ``False`` or a policy name of ``models/rematcfg.py``.

    ``ctx`` with a DeviceMesh: ``params`` are the rank's blocks, the
    batch is the whole one (every rank gets the same; in train mode the
    rank's block of it, ``data.pipeline.shard_batch``), and the results
    are the rank's: logits ``[B_loc, S, V_loc]``, kv with the rank's
    batch block and kv heads, ``caches`` the rank's blocks."""
    check_supported(cfg)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    mw = None
    embeds = cfg.embeds_input and "embeds" in batch
    S = batch["embeds" if embeds else "tokens"].shape[1]
    if ctx is not None and ctx.mesh is not None:
        mw = L.MeshWeights(cfg, ctx, local_batch=mode == "train")
        mw.sp, mw.seq_attn = _perf_layout(cfg, ctx, S, mode)
    if embeds:
        x = batch["embeds"].to(getattr(torch, cfg.dtype))
        if mw is not None:
            x = mw.batch_block(x)
            if mw.sp:
                x = x[:, mw.rows(S)]
    elif mw is None:
        x = L.embed_apply(params["embed"], batch["tokens"])
    else:
        x = mw.embed(params["embed"], batch["tokens"])
    B = x.shape[0]
    layout = img_layout = None
    if mode == "decode":
        positions = torch.full((B, 1), cur_index, dtype=torch.int32,
                               device=x.device)
        if mw is not None:
            whole_b = batch["embeds" if embeds else "tokens"].shape[0]
            layout = _cache_layout(cfg, ctx, whole_b, caches["k"])
            if cfg.family == "vlm":
                img_layout = _cache_layout(cfg, ctx, whole_b,
                                           caches["img_k"], "img_k")
    else:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    ks, vs = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kinds = layer_kinds(cfg)
    # the reference gives MoE stacks no window, whatever the config says
    windows = window_schedule(cfg, len(kinds)) if cfg.n_experts == 0 \
        else [0] * len(kinds)
    if cfg.family == "vlm":
        per = cfg.cross_attn_every
        if mode == "decode":
            img_k, img_v = caches["img_k"], caches["img_v"]
        else:
            img = batch["image_embeds"]
            img_k, img_v = _image_kv(
                params["cross_blocks"],
                img if mw is None else mw.batch_block(img), cfg, mw)
    train = mode == "train"
    if train:
        layer = rematcfg.wrap(_train_layer, remat)
        cross_layer = rematcfg.wrap(_cross_attn, remat)

        def cross(pb, x, img_kv, cfg):
            return cross_layer(pb, x, img_kv, cfg, mw)
    else:
        def cross(pb, x, img_kv, cfg):
            return _cross_attn(pb, x, img_kv, cfg, mw, img_layout)
    for i, pb in enumerate(params["blocks"]):
        d_ff = cfg.d_ff_dense if kinds[i] == "dense_lead" else cfg.d_ff
        if train:
            x, aux_l = layer(pb, x, cfg, positions, windows[i], mw, d_ff)
        else:
            cache = (caches["k"][i], caches["v"][i]) if mode == "decode" \
                else None
            attn_out, (k, v) = _self_attn(pb, x, cfg, positions=positions,
                                          window=windows[i], mode=mode,
                                          cache=cache, cur_index=cur_index,
                                          mw=mw, layout=layout)
            x, aux_l = _mlp_or_moe(pb, x + attn_out, cfg, mw, d_ff)
        if aux_l is not None:
            aux = aux + aux_l
        if mode == "prefill":
            ks.append(k)
            vs.append(v)
        if cfg.family == "vlm" and i % per == per - 1:
            j = i // per
            x = cross(params["cross_blocks"][j], x, (img_k[j], img_v[j]),
                      cfg)
    kv = {"k": torch.stack(ks), "v": torch.stack(vs)} \
        if mode == "prefill" else (None if train else caches)
    if cfg.family == "vlm" and mode == "prefill":
        kv.update(img_k=img_k, img_v=img_v)
    if mw is not None:      # under sp the final norm takes whole rows
        x = mw.enter_rows(x, None)
    if last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    unembed = L.unembed_apply if mw is None else mw.unembed
    return unembed(params["embed"], x), aux, kv


# ---------------------------------------------------------------------------
# on a mesh
# ---------------------------------------------------------------------------
def _perf_layout(cfg: ModelConfig, ctx, S: int, mode: str):
    """(``sp_residual``, ``seq_shard_attn``) for a forward of S positions
    on ``ctx``'s mesh, under the reference's conditions: neither in the
    VLM (its superblocks pass no ctx to their layers), neither at a
    model axis of one; ``sp_residual`` where S divides ``model`` and S
    >= M, but for gemma3's layers under ``banded_local`` (the
    reference's superblock scan keeps them whole), ``seq_shard_attn`` in
    train and prefill where the q heads do not divide ``model``, S does
    and S >= 1024."""
    M = ctx.tp_size
    if cfg.family == "vlm" or M == 1:
        return False, False
    banded = (cfg.local_global_ratio > 0 and cfg.sliding_window > 0
              and mode != "decode" and perfcfg.flag("banded_local"))
    sp = (perfcfg.flag("sp_residual") and S % M == 0 and S >= M
          and not banded)
    seq = (perfcfg.flag("seq_shard_attn") and mode != "decode"
           and cfg.n_heads % M != 0 and S % M == 0 and S >= 1024)
    return sp, seq


def _kv_for_heads(k, v, h0: int, Hl: int, cfg: ModelConfig):
    """k, v [B, S, KV, hd] (every kv head) for the rank's q heads
    ``[h0, h0 + Hl)``: q head h meets kv head h // G. Contiguous, for
    B4: a slice of kv heads where the local heads group evenly over it,
    else one kv head a q head."""
    G = cfg.n_heads // cfg.n_kv_heads
    heads = [(h0 + i) // G for i in range(Hl)]
    kv0, n = heads[0], heads[-1] - heads[0] + 1
    if Hl % n == 0 and all(h - kv0 == i // (Hl // n)
                           for i, h in enumerate(heads)):
        return (k[:, :, kv0:kv0 + n].contiguous(),
                v[:, :, kv0:kv0 + n].contiguous())
    idx = torch.tensor(heads, device=k.device)
    return k[:, :, idx].contiguous(), v[:, :, idx].contiguous()


def _cache_layout(cfg: ModelConfig, ctx, batch_size: int, k_cache,
                  name: str = "k"):
    """(the sequence's mesh axes, the first position of the rank's block)
    of the decode cache block ``k_cache`` [n, B, S_blk, KV, hd] (the
    cache's ``name`` leaf: ``"k"``, or the VLM's ``"img_k"``), as
    ``serve.step.cache_specs`` lays the cache out."""
    from repro_torch.serve.step import cache_specs
    seq = cache_specs(cfg, ctx, batch_size)[name][2]
    max_len = k_cache.shape[2] * ctx.axes_size(seq)
    return seq or (), ctx.block(max_len, seq).start


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: DeviceLike = None, image_kv: Optional[dict] = None
               ) -> dict:
    """Zeroed decode caches ``{"k", "v"}``, each ``[n_layers, B, max_len,
    KV, hd]`` in the config's dtype; the VLM adds ``{"img_k", "img_v"}``,
    each ``[n_superblocks, B, n_image_tokens, KV, hd]``: those of
    ``image_kv`` (a prefill's cache) as they are where it is given, else
    zeroed (the reference keeps its self caches as ``[n_sb, per, B,
    max_len, KV, hd]``; the port's stay flat, one a self layer)."""
    shape = (len(layer_kinds(cfg)), batch_size, max_len, cfg.n_kv_heads,
             cfg.head_dim)
    dtype = getattr(torch, cfg.dtype)
    device = resolve(device)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.family == "vlm" and image_kv is not None:
        cache.update(img_k=image_kv["img_k"], img_v=image_kv["img_v"])
    elif cfg.family == "vlm":
        img = (n_superblocks(cfg), batch_size, cfg.n_image_tokens,
               cfg.n_kv_heads, cfg.head_dim)
        cache.update(img_k=torch.zeros(img, dtype=dtype, device=device),
                     img_v=torch.zeros(img, dtype=dtype, device=device))
    return cache
