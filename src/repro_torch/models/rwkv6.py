"""RWKV-6 "Finch": the port of ``repro.models.rwkv6`` [arXiv:2404.05892].

An attention-free LM with data-dependent decay. Time-mix runs the WKV
recurrence

    o_t = r_tᵀ (diag(u) k_t v_tᵀ + S_t),   S_{t+1} = diag(w_t) S_t + k_t v_tᵀ

with per-channel decay w_t = exp(-exp(w0 + tanh(x W_A) W_B)), in f32;
channel-mix is RWKV's r/k/v form (sigmoid gate, squared ReLU). Same
simplifications as the reference: static token-shift lerp coefficients
(the LoRA kept only for the decay) and a per-head RMS norm in place of
GroupNorm. Params hold one dict a layer (the reference stacks them for
``lax.scan``; the port loops), every leaf with the reference's dtype.

Prefill runs the chunked WKV (``_wkv_chunked``). Within a chunk of C
tokens the pairwise decay D[t, s, d] = exp(cum_{t-1} - cum_s) is
materialized (no exp of a large positive number where it is used), the
scores A[t, s] = sum_d r_t k_s D are masked strictly below the diagonal,
and the bonus u goes on the diagonal; an hd x hd state
crosses chunks. The reference computes every term inside one
``lax.scan`` step per chunk. Here the chunk-local terms (D, the scores
A, the intra-chunk output, the decayed k and r) depend on no carried
state, so they are computed for many chunks at once (D for as many
chunks as fit ``D_BYTES``: 4 of 268 MB at rwkv6-7b's 64 heads and B 4),
a Python loop over the chunks carries only the state, S <- exp(cum_last)
S + k_decᵀ v, and the state's share of the output, (r exp(cum_{t-1}))
S_in, is one batched product after it. Each term is the reference's,
summed in f32. Decode is the O(1)-state step (``_wkv_step``).

Training (``mode="train"``) runs each layer under the remat policy
``remat`` names (``models/rematcfg.py``), as the reference wraps its scan
body, and the WKV scan through ``WKVChunked``: its forward is the scan
above, and its backward recomputes one group of chunks at a time from
the state entering it, as the reference rematerializes each chunk, so
it never holds more than one group's D.

No Pallas kernel runs here in the reference, and none in the port: the
scans are plain PyTorch on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import layers as L
from repro_torch.models import rematcfg

LORA_DIM = 64
MODES = ("prefill", "decode", "train")
D_BYTES = 1 << 30            # the pairwise decay tensor's size a group


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _layer_init(gen: torch.Generator, cfg: ModelConfig,
                keep=L.whole) -> dict:
    """One layer's params: f32 lerp coefficients, decay base, bonus and
    norms; the projections in the config's dtype, ``x @ W``. ``keep``:
    see ``layers.whole``."""
    d, ff = cfg.d_model, cfg.d_ff
    hd = cfg.rwkv_head_size
    H = d // hd
    dtype = getattr(torch, cfg.dtype)
    dev = gen.device

    def full(path, shape, value):
        return keep(path, torch.full(shape, value, dtype=torch.float32,
                                     device=dev))

    def mat(path, i, o, scale=1.0, times=None):
        w = L.dense_init(gen, i, o, dtype, scale)
        return keep(path, w if times is None else w * times)

    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    tm = {name: full(("tm", name), (d,), 0.5)
          for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w")}
    tm["w0"] = full(("tm", "w0"), (d,), -2.0)   # base decay ~exp(-exp(-2))
    tm["wA"] = mat(("tm", "wA"), d, LORA_DIM, times=0.1)
    tm["wB"] = mat(("tm", "wB"), LORA_DIM, d, times=0.1)
    tm["u"] = full(("tm", "u"), (H, hd), 0.0)
    for name in ("wr", "wk", "wv", "wg"):
        tm[name] = mat(("tm", name), d, d)
    tm["wo"] = mat(("tm", "wo"), d, d, out_scale)
    tm["ln_x"] = full(("tm", "ln_x"), (d,), 1.0)
    cm = {"mu_r": full(("cm", "mu_r"), (d,), 0.5),
          "mu_k": full(("cm", "mu_k"), (d,), 0.5),
          "wr": mat(("cm", "wr"), d, d), "wk": mat(("cm", "wk"), d, ff),
          "wv": mat(("cm", "wv"), ff, d, out_scale)}
    return {"ln1": full(("ln1",), (d,), 1.0),
            "ln2": full(("ln2",), (d,), 1.0), "tm": tm, "cm": cm}


def init(gen: torch.Generator, cfg: ModelConfig, keep=L.whole) -> dict:
    """Random params on the generator's device: ``{"embed", "blocks":
    [one dict a layer], "final_norm"}``. ``keep``: see ``layers.whole``."""
    return {"embed": L.embed_init(gen, cfg, keep=L.under(keep, "embed")),
            "blocks": [_layer_init(gen, cfg, L.under(keep, "blocks", i))
                       for i in range(cfg.n_layers)],
            "final_norm": keep(("final_norm",), torch.ones(
                cfg.d_model, dtype=torch.float32, device=gen.device))}


# ---------------------------------------------------------------------------
# WKV
# ---------------------------------------------------------------------------
def _group(B: int, H: int, C: int, hd: int) -> int:
    """Chunks a group: as many as fit ``D_BYTES`` of the f32 decay
    tensor."""
    return max(1, D_BYTES // (B * H * C * C * hd * 4))


def _wkv_chunked(r, k, v, lw, u, state, chunk: int):
    """r, k, v: [B, T, H, hd]; lw: [B, T, H, hd] log-decay (<= 0); u:
    [H, hd]; state: [B, H, hd, hd]. Returns (out [B, T, H, hd] in r's
    dtype, state f32). Where grad mode is on and an input requires grad,
    through ``WKVChunked``, whose forward is this same scan."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, lw, u, state)):
        return WKVChunked.apply(r, k, v, lw, u, state, chunk)
    return _wkv_forward(r, k, v, lw, u, state, chunk)[:2]


def _wkv_forward(r, k, v, lw, u, state, chunk: int):
    """The grouped scan: (out, state f32, s_in [B, H, n, hd, hd] f32, the
    state entering each chunk)."""
    B, T, H, hd = r.shape
    C = L.chunk_split(T, chunk)
    n = T // C

    def resh(x):  # [B, T, H, hd] -> [B, H, n, C, hd], f32
        return x.float().reshape(B, n, C, H, hd).permute(0, 3, 1, 2, 4)

    rc, kc, vc, lwc = resh(r), resh(k), resh(v), resh(lw)
    cum = torch.cumsum(lwc, dim=3)                       # inclusive
    cum_prev = cum - lwc                                 # cum_{t-1}
    below = torch.ones((C, C), dtype=torch.bool, device=r.device).tril(-1)
    bonus = (rc * u[None, :, None, None, :] * kc).sum(-1)  # [B, H, n, C]
    y = torch.empty_like(vc)
    group = _group(B, H, C, hd)
    for c0 in range(0, n, group):
        g = slice(c0, c0 + group)
        # D[t, s, d] = exp(cum_prev[t] - cum[s]), used only for s < t: the
        # mask goes on A, 1/hd of D's size (an entry at s >= t may
        # overflow, and only its own A[t, s] sees it)
        D = (cum_prev[:, :, g, :, None, :] - cum[:, :, g, None, :, :]).exp_()
        D.mul_(kc[:, :, g, None, :, :])                  # k_s D[t, s]
        A = (D @ rc[:, :, g, :, :, None]).squeeze(-1)    # [B, H, g, t, s]
        del D
        A.masked_fill_(~below, 0.0)
        A.diagonal(dim1=-2, dim2=-1).add_(bonus[:, :, g])
        y[:, :, g] = A @ vc[:, :, g]
    # the carry: S_in of each chunk, then its share of the output
    cum_last = cum[:, :, :, -1:, :]                      # [B, H, n, 1, hd]
    kv = (kc * torch.exp(cum_last - cum)).transpose(-1, -2) @ vc
    decay = torch.exp(cum_last[:, :, :, 0, :, None])     # [B, H, n, hd, 1]
    S = state.float()
    s_in = torch.empty_like(kv)                          # [B, H, n, hd, hd]
    for c in range(n):
        s_in[:, :, c] = S
        S = decay[:, :, c] * S + kv[:, :, c]
    y = y + (rc * torch.exp(cum_prev)) @ s_in
    out = y.permute(0, 2, 3, 1, 4).reshape(B, T, H, hd)
    return out.to(r.dtype), S, s_in


def _wkv_group(r, k, v, lw, u, S, C: int):
    """The scan over the chunks of C tokens in r, k, v, lw ([B, n C, H,
    hd]) from the state S [B, H, hd, hd] f32, out of place for autograd:
    (out in r's dtype, the state after). D's exponent is set to -inf
    before ``exp`` where s >= t, so a masked entry is an exact 0 and its
    gradient too (where an entry overflows, exp's backward would give
    0 x inf = NaN: ROADMAP C22)."""
    B, T, H, hd = r.shape
    n = T // C

    def resh(x):
        return x.float().reshape(B, n, C, H, hd).permute(0, 3, 1, 2, 4)

    rc, kc, vc, lwc = resh(r), resh(k), resh(v), resh(lw)
    cum = torch.cumsum(lwc, dim=3)
    cum_prev = cum - lwc
    below = torch.ones((C, C), dtype=torch.bool, device=r.device).tril(-1)
    D = torch.exp(torch.where(below[:, :, None],
                              cum_prev[:, :, :, :, None, :]
                              - cum[:, :, :, None, :, :], -math.inf))
    D = D * kc[:, :, :, None, :, :]                      # k_s D[t, s]
    A = (D @ rc[..., None]).squeeze(-1) + torch.diag_embed(
        (rc * u[None, :, None, None, :] * kc).sum(-1))
    y = A @ vc
    cum_last = cum[:, :, :, -1:, :]
    kv = (kc * torch.exp(cum_last - cum)).transpose(-1, -2) @ vc
    decay = torch.exp(cum_last[:, :, :, 0, :, None])
    s_in = []
    for c in range(n):
        s_in.append(S)
        S = decay[:, :, c] * S + kv[:, :, c]
    y = y + (rc * torch.exp(cum_prev)) @ torch.stack(s_in, dim=2)
    out = y.permute(0, 2, 3, 1, 4).reshape(B, T, H, hd)
    return out.to(r.dtype), S


def wkv_chunked_plain(r, k, v, lw, u, state, chunk: int):
    """The WKV scan for plain autograd, one chunk at a time and out of
    place (``_wkv_group`` a chunk): its graph keeps every chunk's D. What
    ``WKVChunked``'s gradients are held against (tests, chip_smoke);
    nothing on the main path calls it."""
    T = r.shape[1]
    C = L.chunk_split(T, chunk)
    S, outs = state.float(), []
    for t0 in range(0, T, C):
        t = slice(t0, t0 + C)
        y, S = _wkv_group(r[:, t], k[:, t], v[:, t], lw[:, t], u, S, C)
        outs.append(y)
    return torch.cat(outs, dim=1), S


class WKVChunked(torch.autograd.Function):
    """The WKV scan with a backward that holds one group of chunks at a
    time: the reference's per-chunk ``jax.checkpoint(nothing_saveable)``
    (``repro.models.rwkv6._wkv_chunked``) at the port's group size.

    The forward is ``_wkv_forward``, the no-grad scan bit for bit; it
    saves r, k, v, lw, u and s_in, the state entering each chunk (67 MB
    a layer at rwkv6-7b's full size and B 4). The backward walks the
    groups last to first: it recomputes a group from its s_in with
    ``_wkv_group`` under grad mode, pushes (the group's dout, dS out of
    the group) through with ``torch.autograd.grad``, and hands dS at the
    group's start to the group before it. So it holds one group's D
    (``D_BYTES``) and that graph's products of D's size, whatever the
    remat policy."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, state, chunk):
        out, S, s_in = _wkv_forward(r, k, v, lw, u, state, chunk)
        ctx.save_for_backward(r, k, v, lw, u, s_in)
        ctx.chunk = chunk
        return out, S

    @staticmethod
    def backward(ctx, dout, dS):
        r, k, v, lw, u, s_in = ctx.saved_tensors
        B, T, H, hd = r.shape
        C = L.chunk_split(T, ctx.chunk)
        n = T // C
        group = _group(B, H, C, hd)
        grads = [torch.empty_like(t) for t in (r, k, v, lw)]
        du = torch.zeros_like(u)
        for c0 in reversed(range(0, n, group)):
            ts = slice(c0 * C, min(n, c0 + group) * C)
            with torch.enable_grad():
                leaves = [t[:, ts].detach().requires_grad_()
                          for t in (r, k, v, lw)]
                u_ = u.detach().requires_grad_()
                S0 = s_in[:, :, c0].detach().requires_grad_()
                y, S1 = _wkv_group(*leaves, u_, S0, C)
                g = torch.autograd.grad((y, S1), (*leaves, u_, S0),
                                        (dout[:, ts], dS))
            for dst, src in zip(grads, g[:4]):
                dst[:, ts] = src
            du += g[4]
            dS = g[5]
        need = ctx.needs_input_grad
        return (*(gr if need[i] else None for i, gr in enumerate(grads)),
                du if need[4] else None, dS if need[5] else None, None)


def _wkv_step(r, k, v, lw, u, state):
    """One decode step. r, k, v, lw: [B, H, hd]; state: [B, H, hd, hd]."""
    rf, kf, vf = r.float(), k.float(), v.float()
    att = state + u[None, :, :, None] * kf[..., None] * vf[..., None, :]
    out = (rf[..., None, :] @ att).squeeze(-2)
    state = torch.exp(lw.float())[..., None] * state + \
        kf[..., None] * vf[..., None, :]
    return out.to(r.dtype), state


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _shift(x, last):
    """Token shift: the previous token's value. last: [B, 1, d] carried."""
    return torch.cat([last, x[:, :-1]], dim=1)


def _lerp(x, xprev, mu):
    return x + (xprev - x) * mu.to(x.dtype)


def _entry(mw):
    """Megatron's "f" over ``model`` on a mesh (``mw``), else the
    identity: a replicated value that enters the rank's heads."""
    if mw is None:
        return lambda t: t
    return lambda t: mw.enter(t, mw.tp)


def _time_mix(p, x, cfg: ModelConfig, state, chunk: int = 64,
              single: bool = False, mw=None):
    """RWKV's time mix. On a mesh (``mw``; ``p`` the rank's, from
    ``MeshWeights.rwkv_time_mix``) the four lerps that meet the
    column-parallel ``wr``, ``wk``, ``wv`` and ``wg``, and the decay's
    ``tanh(xw @ wA)`` that meets the rank's columns of ``wB``, enter
    through "f": ``wA`` and the lerp coefficients are whole, and their
    gradients come out summed over the heads of every rank."""
    B, T, _ = x.shape
    hd = cfg.rwkv_head_size
    f = _entry(mw)
    last = state["tm_x"][:, None, :]
    xprev = last if single else _shift(x, last)
    r = f(_lerp(x, xprev, p["mu_r"])) @ p["wr"]
    k = f(_lerp(x, xprev, p["mu_k"])) @ p["wk"]
    v = f(_lerp(x, xprev, p["mu_v"])) @ p["wv"]
    g = L.silu(f(_lerp(x, xprev, p["mu_g"])) @ p["wg"])
    xw = _lerp(x, xprev, p["mu_w"]).float()
    lw = -torch.exp(p["w0"][None, None] + f(torch.tanh(xw @ p["wA"].float()))
                    @ p["wB"].float())                  # log w_t <= 0
    H = r.shape[-1] // hd          # a rank's heads on a mesh, else all
    r, k, v, lw = (t.reshape(B, T, H, hd) for t in (r, k, v, lw))
    if single:
        o, s_new = _wkv_step(r[:, 0], k[:, 0], v[:, 0], lw[:, 0], p["u"],
                             state["wkv"])
        o = o[:, None]
    else:
        o, s_new = _wkv_chunked(r, k, v, lw, p["u"], state["wkv"], chunk)
    # per-head norm, then the gate
    o = L.rms_norm(o, torch.ones(hd, dtype=torch.float32, device=x.device),
                   cfg.norm_eps)
    o = o.reshape(B, T, H * hd) * p["ln_x"].to(o.dtype)
    return (o * g) @ p["wo"], {"wkv": s_new, "tm_x": x[:, -1, :]}


def _channel_mix(p, x, state, single: bool = False, mw=None, over=None):
    """RWKV's channel mix. On a mesh (``mw``; ``over``: the spec entries
    of ``wr``'s and ``wk``'s output dims and ``wv``'s input dim) the
    lerps enter the column-parallel ``wr`` and ``wk`` through "f", r
    comes out sharded over ``model`` on d and is gathered there (the
    backward a slice), and ``k @ wv``, row-parallel, is summed there,
    before their product."""
    last = state["cm_x"][:, None, :]
    xprev = last if single else _shift(x, last)
    xr, xk = _lerp(x, xprev, p["mu_r"]), _lerp(x, xprev, p["mu_k"])
    if mw is not None:
        xr, xk = mw.enter(xr, over[0]), mw.enter(xk, over[1])
    r = torch.sigmoid(xr @ p["wr"])
    k = torch.square(torch.relu(xk @ p["wk"]))
    y = k @ p["wv"]
    if mw is not None:
        r, y = mw.gather_tp(r, over[0]), mw.row_sum(y, over[2])
    return r * y, {"cm_x": x[:, -1, :]}


def block_apply(pb, x, cfg: ModelConfig, state, *, chunk: int = 64,
                single: bool = False, mw=None):
    """One layer. x: [B, T, d]; state: this layer's ``{"wkv", "tm_x",
    "cm_x"}``. Returns (x, the layer's new state). On a mesh (``mw``, a
    ``layers.MeshWeights``) x is the rank's batch block, whole over
    ``model``, and the WKV state holds the rank's heads: the time mix
    runs r, k, v, g, the decay and the scan on those heads, then the
    per-head norm, and ``wo`` row-parallel, summed over ``model``."""
    tm, cm, wo_over, over = pb["tm"], pb["cm"], None, None
    if mw is not None:
        tm, wo_over = mw.rwkv_time_mix(tm)
        cm, *over = mw.rwkv_channel_mix(cm)
    y, tm_state = _time_mix(tm, L.rms_norm(x, pb["ln1"], cfg.norm_eps),
                            cfg, state, chunk=chunk, single=single, mw=mw)
    if mw is not None:
        y = mw.row_sum(y, wo_over)
    x = x + y
    y, cm_state = _channel_mix(cm, L.rms_norm(x, pb["ln2"], cfg.norm_eps),
                               state, single=single, mw=mw, over=over)
    return x + y, {**tm_state, **cm_state}


# ---------------------------------------------------------------------------
# model-level forward
# ---------------------------------------------------------------------------
def init_state(cfg: ModelConfig, batch_size: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None,
               heads: Optional[int] = None) -> dict:
    """Zeroed recurrent state of every layer: ``wkv`` f32 ``[n, B, H,
    hd, hd]`` (``heads`` of them, default all: a rank's on a mesh),
    ``tm_x`` and ``cm_x`` ``[n, B, d]`` in ``dtype`` (default the
    config's)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    device = resolve(device)
    d, hd, n = cfg.d_model, cfg.rwkv_head_size, cfg.n_layers
    H = d // hd if heads is None else heads
    return {"wkv": torch.zeros((n, batch_size, H, hd, hd),
                               dtype=torch.float32, device=device),
            "tm_x": torch.zeros((n, batch_size, d), dtype=dtype,
                                device=device),
            "cm_x": torch.zeros((n, batch_size, d), dtype=dtype,
                                device=device)}


def _train_block(pb, x, cfg: ModelConfig, state, chunk: int, mw=None):
    """One layer of a training forward: x only (the state is dropped); on
    a mesh (``mw``) ``block_apply``'s mesh path."""
    return block_apply(pb, x, cfg, state, chunk=chunk, mw=mw)[0]


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            mode: str = "prefill", caches: Optional[dict] = None,
            cur_index: Optional[int] = None, last_only: bool = False,
            chunk: int = 64, remat=True, ctx=None):
    """batch: ``{"tokens": [B, T]}`` (``T == 1`` in decode). Returns
    (logits, aux, state): ``aux`` is an f32 zero (no experts); in prefill
    ``state`` is the new recurrent state, stacked ``[n, ...]`` as
    ``init_state``'s, from ``caches`` or zeros; in decode it is
    ``caches``, updated in place; in train it is ``None``. ``cur_index``
    is unused (the state is the position). ``last_only`` unembeds only
    the last position. ``remat`` (train only): ``True`` (the default
    policy), ``False`` or a policy name of ``models/rematcfg.py``, each
    layer under it as the reference wraps its scan body.

    ``ctx`` with a DeviceMesh: ``params`` are the rank's blocks
    (``distributed/sharding.py``), the batch is the whole one (in train
    mode the rank's block of it, ``data.pipeline.shard_batch``), and the
    results are the rank's, as the reference's constraints lay them out
    (``src/repro/models/rwkv6.py:221-236``): the batch over ``dp_axes``
    where it divides, the residual whole over ``model``, the WKV state's
    heads over ``model`` (``serve.step.cache_specs`` ``"ssm"``), the
    logits ``[B_loc, T, V/M]``. Each layer runs ``block_apply``'s mesh
    path (in training under the remat policy, its gradients through
    ``distributed.compat``'s collectives); the embedding and unembedding
    are ``layers.MeshWeights``'."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    mw = None
    if ctx is not None and ctx.mesh is not None:
        mw = L.MeshWeights(cfg, ctx, local_batch=mode == "train")
    if mw is None:
        x = L.embed_apply(params["embed"], batch["tokens"])
    else:
        x = mw.embed(params["embed"], batch["tokens"])
    B = x.shape[0]
    H = cfg.d_model // cfg.rwkv_head_size
    if mw is not None:
        h = mw.heads(H, "WKV")
        H = h.stop - h.start
    state = caches if caches is not None else \
        init_state(cfg, B, x.dtype, x.device, heads=H)
    single = mode == "decode"
    train = mode == "train"
    layer = rematcfg.wrap(_train_block, remat) if train else None
    layers = []
    for i, pb in enumerate(params["blocks"]):
        st_in = {k: t[i] for k, t in state.items()}
        if train:
            x = layer(pb, x, cfg, st_in, chunk, mw)
            continue
        x, st = block_apply(pb, x, cfg, st_in, chunk=chunk, single=single,
                            mw=mw)
        if single:
            for k, t in st.items():
                state[k][i].copy_(t)
        else:
            layers.append(st)
    if train:
        state = None
    elif not single:
        state = {k: torch.stack([st[k] for st in layers]) for k in state}
    if last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    unembed = L.unembed_apply if mw is None else mw.unembed
    return unembed(params["embed"], x), aux, state
