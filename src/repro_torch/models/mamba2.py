"""Mamba-2 (SSD) block: the port of ``repro.models.mamba2``
[arXiv:2405.21060], the backbone of the Zamba2 hybrid.

State-space recurrence per head, with a scalar decay a_t per head:

    h_t = a_t h_{t-1} + (dt_t x_t) B_tᵀ,    y_t = C_t h_t + D x_t

Prefill runs the chunked SSD form (``_ssd_chunked``): within a chunk the
decay couples only (t, s) scalars per head, so the intra-chunk term is a
product of G = C Bᵀ, the masked decay Dm and dt; an hd x N state crosses
chunks. The reference computes every term inside one ``lax.scan`` step
per chunk. Here the chunk-local terms (G, Dm, the intra-chunk output and
each chunk's state increment) depend on no carried state, so they are
computed for all chunks at once (Dm is [B, n, C, C, nh] f32: 64 MB for
16 chunks at zamba2's width and B 4), a Python loop over the chunks
carries only the state, h <- exp(cum_last) h + increment, and the
state's share of the output, exp(cum_t) C_t · h_in, is one batched
product after it. Decode is the O(1) recurrence (``_ssd_step``).

Training runs this same code under plain autograd (the reference
rematerializes each chunk; here Dm is small, and the hybrid's per-layer
remat recomputes the layer in the backward): the decay's exponent is
masked to -inf before ``exp``, so a masked entry and its gradient are
exact zeros.

A layer's params are one dict (the reference stacks them); ``conv_w``,
``A_log``, ``D``, ``dt_bias`` and the norms are f32, the projections in
the config's dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, draws, resolve
from repro_torch.models import layers as L

CONV_K = 4  # depthwise causal conv kernel size


def _dims(cfg: ModelConfig):
    """(d_inner, N, head dim, heads, conv channels)."""
    d_in, N, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_headdim
    return d_in, N, hd, d_in // hd, d_in + 2 * N


def layer_init(gen: torch.Generator, cfg: ModelConfig,
               keep=L.whole) -> dict:
    """One Mamba2 layer's params on the generator's device. ``keep``: see
    ``layers.whole``."""
    d = cfg.d_model
    d_in, N, _, nh, conv_dim = _dims(cfg)
    dtype = getattr(torch, cfg.dtype)
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    conv_w = torch.empty((CONV_K, conv_dim), **f32)     # drawn first
    if draws(gen):
        conv_w.normal_(0.0, 1.0, generator=gen)
    conv_w = keep(("conv_w",), conv_w * (1.0 / math.sqrt(CONV_K)))
    p = {"norm": keep(("norm",), torch.ones(d, **f32)),
         "in_proj": keep(("in_proj",), L.dense_init(
             gen, d, 2 * d_in + 2 * N + nh, dtype)),
         "conv_w": conv_w}
    # a = exp(-exp(A_log) * dt)
    p["A_log"] = keep(("A_log",), torch.zeros(nh, **f32))
    p["D"] = keep(("D",), torch.ones(nh, **f32))
    p["dt_bias"] = keep(("dt_bias",), torch.zeros(nh, **f32))
    p["gate_norm"] = keep(("gate_norm",), torch.ones(d_in, **f32))
    p["out_proj"] = keep(("out_proj",), L.dense_init(
        gen, d_in, d, dtype, scale=1.0 / math.sqrt(2 * cfg.n_layers)))
    return p


def init_state(cfg: ModelConfig, n: int, batch_size: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None,
               heads: Optional[int] = None) -> dict:
    """Zeroed state of ``n`` layers: ``h`` f32 ``[n, B, nh, hd, N]``
    (``heads`` of them, default all: a rank's on a mesh) and ``conv``
    ``[n, B, CONV_K - 1, conv channels]`` in ``dtype`` (default the
    config's)."""
    _, N, hd, nh, conv_dim = _dims(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    device = resolve(device)
    nh = nh if heads is None else heads
    return {"h": torch.zeros((n, batch_size, nh, hd, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((n, batch_size, CONV_K - 1, conv_dim),
                                dtype=dtype, device=device)}


def _causal_conv(x, w, conv_state):
    """Depthwise causal conv, then silu. x: [B, T, C]; w: [K, C] f32;
    conv_state: [B, K-1, C]. One form serves prefill and a decode step
    (T = 1). The reference's einsum over the K taps in x's dtype sums the
    products in f32 and rounds once: so here, taps in order."""
    ctx = torch.cat([conv_state.to(x.dtype), x], dim=1)
    T = x.shape[1]
    wx = w.to(x.dtype).float()
    out = ctx[:, :T].float() * wx[0]
    for i in range(1, CONV_K):
        out = out + ctx[:, i:i + T].float() * wx[i]
    return L.silu(out.to(x.dtype)), ctx[:, -(CONV_K - 1):]


def _ssd_chunked(x, dt, B_, C_, a_log, h0, chunk: int):
    """x: [B, T, nh, hd]; dt, a_log (log a): [B, T, nh]; B_, C_: [B, T,
    N]; h0: [B, nh, hd, N]. Returns (y [B, T, nh, hd] in x's dtype, h)."""
    Bb, T, nh, hd = x.shape
    N = B_.shape[-1]
    Cn = L.chunk_split(T, chunk)
    n = T // Cn

    def resh(t):  # [B, T, ...] -> [B, n, Cn, ...], f32
        return t.float().reshape((Bb, n, Cn) + t.shape[2:])

    xc, dtc, Bc, Cc, alc = (resh(t) for t in (x, dt, B_, C_, a_log))
    cum = torch.cumsum(alc, dim=2)                       # [B, n, Cn, nh]
    # intra: score[t, s] = (C_t . B_s) exp(cum_t - cum_s) dt_s, s <= t
    G = Cc @ Bc.transpose(-1, -2)                        # [B, n, t, s]
    tri = torch.ones((Cn, Cn), dtype=torch.bool, device=x.device).tril()
    Dm = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B, n, t, s, nh]
    Dm.masked_fill_(~tri[:, :, None], -math.inf).exp_()
    scores = G[..., None] * Dm * dtc[:, :, None, :, :]
    y = (scores.permute(0, 1, 4, 2, 3) @ xc.permute(0, 1, 3, 2, 4)
         ).permute(0, 1, 3, 2, 4)                        # [B, n, t, nh, hd]
    # each chunk's state increment: sum_s exp(cum_last - cum_s) dt_s x_s B_sᵀ
    cum_last = cum[:, :, -1:, :]
    w_s = torch.exp(cum_last - cum) * dtc                # [B, n, Cn, nh]
    inc = (w_s[..., None] * xc).permute(0, 1, 3, 4, 2) @ Bc[:, :, None]
    decay = torch.exp(cum_last[:, :, 0])[..., None, None]  # [B, n, nh, 1, 1]
    h = h0.float()
    h_in = torch.empty_like(inc)                         # [B, n, nh, hd, N]
    for c in range(n):
        h_in[:, c] = h
        h = decay[:, c] * h + inc[:, c]
    # inter: y_t += exp(cum_t) C_t . h_in
    inter = h_in.reshape(Bb, n, nh * hd, N) @ Cc.transpose(-1, -2)
    inter = inter.reshape(Bb, n, nh, hd, Cn).permute(0, 1, 4, 2, 3)
    y = y + inter * torch.exp(cum)[..., None]
    return y.reshape(Bb, T, nh, hd).to(x.dtype), h


def _ssd_step(x, dt, B_, C_, a_log, h):
    """One token. x: [B, nh, hd]; dt, a_log: [B, nh]; B_, C_: [B, N]."""
    xf = x.float()
    a = torch.exp(a_log.float())                          # [B, nh]
    h = a[:, :, None, None] * h + (dt.float()[:, :, None] * xf)[..., None] \
        * B_.float()[:, None, None, :]
    y = (h @ C_.float()[:, None, :, None]).squeeze(-1)    # [B, nh, hd]
    return y.to(x.dtype), h


def block_apply(pb, x, cfg: ModelConfig, state, *, chunk: int = 64,
                single: bool = False, mw=None):
    """One Mamba2 block. x: [B, T, d]; state: this layer's ``{"h",
    "conv"}``. Returns (x, the layer's new state).

    On a mesh (``mw``, a ``layers.MeshWeights``) x is the rank's batch
    block, whole over ``model``. ``in_proj`` and the conv run whole on
    every ``model`` rank (the reference's layout: the fused sections are
    not TP-aligned, and ``cache_specs`` keeps ``conv`` whole there); the
    SSD runs on the rank's heads, whose state ``h`` holds them. The
    gated RMSNorm normalizes over the whole d_inner, so y is gathered
    over ``model`` first and the norm is one device's, bit for bit (an
    all-reduce of the sum of squares would add its partial sums in
    another order). The rank's channels of the normed y then meet its
    rows of ``out_proj``, summed over ``model``.

    The gradients follow ``distributed.compat``'s convention: ``in_proj``'s
    output is replicated over ``model``, and of it z is used whole (after
    y's gather, whose backward is a slice), while the heads of ``xs`` and
    ``dt`` and the B and C that every head reads meet the rank's heads
    only. So "f" (``MeshWeights.enter``) sits where the heads are cut, on
    ``xbc`` after the conv and on ``dt_raw``, and on the normed y before
    its cut to the rank's channels; never on ``in_proj``'s input, where
    it would sum z's replicated gradient once a rank."""
    B, T, d = x.shape
    d_in, N, hd, nh, _ = _dims(cfg)
    if mw is not None:
        pb, heads, over = mw.mamba(pb)
    xn = L.rms_norm(x, pb["norm"], cfg.norm_eps)
    proj = xn @ pb["in_proj"]
    z, xbc, dt_raw = (proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * N],
                      proj[..., 2 * d_in + 2 * N:])
    xbc, conv_state = _causal_conv(xbc, pb["conv_w"], state["conv"])
    if mw is not None:
        xbc, dt_raw = mw.enter(xbc, mw.tp), mw.enter(dt_raw, mw.tp)
    xs = xbc[..., :d_in].reshape(B, T, nh, hd)
    if mw is not None:
        xs, dt_raw = xs[:, :, heads], dt_raw[..., heads]
    B_, C_ = xbc[..., d_in:d_in + N], xbc[..., d_in + N:]
    # softplus as jax.nn.softplus: logaddexp(v, 0), in f32
    v = dt_raw.float() + pb["dt_bias"][None, None, :]
    dt = torch.logaddexp(v, torch.zeros_like(v))          # [B, T, nh]
    a_log = -torch.exp(pb["A_log"])[None, None, :] * dt   # log a_t
    if single:
        y, h = _ssd_step(xs[:, 0], dt[:, 0], B_[:, 0], C_[:, 0], a_log[:, 0],
                         state["h"])
        y = y[:, None]
    else:
        y, h = _ssd_chunked(xs, dt, B_, C_, a_log, state["h"], chunk)
    y = y + xs * pb["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, T, -1)
    if mw is not None:
        y = mw.gather_tp(y, mw.tp)
    y = L.rms_norm(y * L.silu(z), pb["gate_norm"], cfg.norm_eps)
    if mw is None:
        return x + y @ pb["out_proj"], {"h": h, "conv": conv_state}
    y = mw.enter(y, over)[..., mw.ctx.block(d_in, over)] @ pb["out_proj"]
    return x + mw.row_sum(y, over), {"h": h, "conv": conv_state}
