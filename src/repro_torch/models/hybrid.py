"""Zamba2 hybrid: the port of ``repro.models.hybrid`` [arXiv:2411.15242].

A Mamba2 backbone of ``n_layers`` blocks (``models/mamba2.py``) and one
attention + MLP block whose weights are *shared*: it is applied after
every ``attn_every``-th Mamba layer, at ``n_attn_sites`` sites (zamba2:
6 sites for 38 layers; the last segment, layers 36-37, has none). The
shared block is the transformer's (``transformer._self_attn``, global,
with RoPE, then a SwiGLU FFN), so its prefill attention is kernel B4
(``layers.blockwise_attention``; zamba2 runs full multi-head attention,
32 heads over 32, at hd 64) and its decode attention is
``layers.decode_attention`` over a cache of one site's k and v.

Decode carries the O(1) Mamba state and a KV cache a site, ``[sites, B,
max_len, KV, hd]``, both updated in place. A prefill returns the Mamba
state and the k and v of its S positions; ``serve.step.generate`` copies
them into a cache of ``max_len`` positions before decoding (ROADMAP C20:
the reference's ``generate`` hands the prompt-sized cache on, and its
decode writes clamp onto position S-1).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import layers as L
from repro_torch.models import mamba2, rematcfg
from repro_torch.models.transformer import _cache_layout, _self_attn


MODES = ("prefill", "decode", "train")


def segments(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """Mamba-layer index ranges between shared-attention sites."""
    out, start = [], 0
    for i in range(cfg.n_layers):
        if (i + 1) % cfg.attn_every == 0:
            out.append((start, i + 1))
            start = i + 1
    if start < cfg.n_layers:
        out.append((start, cfg.n_layers))
    return out


def n_attn_sites(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def _site(cfg: ModelConfig, b: int) -> Optional[int]:
    """The shared block's site after the segment ending at layer ``b``,
    or None where the segment ends without one."""
    if b % cfg.attn_every == 0 and b <= n_attn_sites(cfg) * cfg.attn_every:
        return b // cfg.attn_every - 1
    return None


def init(gen: torch.Generator, cfg: ModelConfig, keep=L.whole) -> dict:
    """Random params on the generator's device: ``{"embed", "mamba":
    [one dict a layer], "shared_attn": {"ln1", "attn", "ln2", "mlp"},
    "final_norm"}``. ``keep``: see ``layers.whole``."""
    dev = gen.device
    sh = L.under(keep, "shared_attn")

    def ones(k, path):
        return k(path, torch.ones(cfg.d_model, dtype=torch.float32,
                                  device=dev))
    p = {"embed": L.embed_init(gen, cfg, keep=L.under(keep, "embed")),
         "mamba": [mamba2.layer_init(gen, cfg, L.under(keep, "mamba", i))
                   for i in range(cfg.n_layers)]}
    p["shared_attn"] = {
        "ln1": ones(sh, ("ln1",)),
        "attn": L.attn_init(gen, cfg, keep=L.under(sh, "attn")),
        "ln2": ones(sh, ("ln2",)),
        "mlp": L.ffn_init(gen, cfg, keep=L.under(sh, "mlp"))}
    p["final_norm"] = ones(keep, ("final_norm",))
    return p


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: DeviceLike = None) -> dict:
    """Zeroed decode cache: ``{"mamba": mamba2.init_state(...), "k",
    "v"}``, k and v ``[sites, B, max_len, KV, hd]`` in the config's
    dtype."""
    dtype = getattr(torch, cfg.dtype)
    device = resolve(device)
    kv = (n_attn_sites(cfg), batch_size, max_len, cfg.n_kv_heads,
          cfg.head_dim)
    return {"mamba": mamba2.init_state(cfg, cfg.n_layers, batch_size, dtype,
                                       device),
            "k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device)}


def _train_block(pb, x, cfg: ModelConfig, state, chunk: int, mw=None):
    """One Mamba layer of a training forward: x only; on a mesh (``mw``)
    ``mamba2.block_apply``'s mesh path."""
    return mamba2.block_apply(pb, x, cfg, state, chunk=chunk, mw=mw)[0]


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            mode: str = "prefill", caches: Optional[dict] = None,
            cur_index: Optional[int] = None, last_only: bool = False,
            chunk: int = 64, remat=True, ctx=None):
    """batch: ``{"tokens": [B, S]}`` (``S == 1`` in decode). Returns
    (logits, aux, cache): ``aux`` an f32 zero; in prefill ``cache`` is
    ``{"mamba": the new state, stacked as init_state's, "k", "v": [sites,
    B, S, KV, hd]}`` (the Mamba state starts from ``caches["mamba"]`` if
    given, else zeros); in decode it is ``caches``, updated in place at
    ``cur_index``; in train it is ``None``. ``last_only`` unembeds only
    the last position. ``remat`` (train only): the policy each Mamba
    layer runs under (``models/rematcfg.py``), as the reference wraps its
    segments' scan body; the shared block is not rematerialized (the
    reference unrolls it outside the scan), and its attention trains
    through ``layers.Attention``, B4 with its lse.

    ``ctx`` with a DeviceMesh: ``params`` are the rank's blocks, the
    batch is the whole one (in train mode the rank's block of it,
    ``data.pipeline.shard_batch``), and the results are the rank's, as
    the reference's constraints lay them out
    (``src/repro/models/hybrid.py:69-130``): the batch over ``dp_axes``
    where it divides, the residual whole over ``model``; each Mamba layer
    through ``mamba2.block_apply``'s mesh path (the SSD state's heads
    over ``model``); the shared block through ``transformer._self_attn``
    (B4 on the rank's heads; in training with its lse, the shared
    leaves' gradients summed over the sites by autograd) and
    ``MeshWeights.ffn``; the cache as ``serve.step.cache_specs``
    ``"hybrid"`` lays it out, its k and v as the transformers' (grown by
    ``serve.step.decode_cache``, ROADMAP C20); the logits ``[B_loc, S,
    V/M]``."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    mw = None
    if ctx is not None and ctx.mesh is not None:
        mw = L.MeshWeights(cfg, ctx, local_batch=mode == "train")
    if mw is None:
        x = L.embed_apply(params["embed"], batch["tokens"])
    else:
        x = mw.embed(params["embed"], batch["tokens"])
    B, S = x.shape[:2]
    single = mode == "decode"
    nh = cfg.d_inner // cfg.ssm_headdim
    if mw is not None:
        h = mw.heads(nh, "SSD")
        nh = h.stop - h.start
    mstate = caches["mamba"] if caches is not None else \
        mamba2.init_state(cfg, cfg.n_layers, B, x.dtype, x.device, heads=nh)
    layout = None
    if single:
        positions = torch.full((B, 1), cur_index, dtype=torch.int32,
                               device=x.device)
        if mw is not None and n_attn_sites(cfg):
            layout = _cache_layout(cfg, ctx, batch["tokens"].shape[0],
                                   caches["k"])
    else:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    sh = params["shared_attn"]
    train = mode == "train"
    layer = rematcfg.wrap(_train_block, remat) if train else None
    layers, ks, vs = [], [], []
    for a, b in segments(cfg):
        for i in range(a, b):
            st_in = {k: t[i] for k, t in mstate.items()}
            if train:
                x = layer(params["mamba"][i], x, cfg, st_in, chunk, mw)
                continue
            x, st = mamba2.block_apply(params["mamba"][i], x, cfg, st_in,
                                       chunk=chunk, single=single, mw=mw)
            if single:
                for k, t in st.items():
                    mstate[k][i].copy_(t)
            else:
                layers.append(st)
        site = _site(cfg, b)
        if site is None:
            continue
        cache = (caches["k"][site], caches["v"][site]) if single else None
        attn_out, (k, v) = _self_attn(sh, x, cfg, positions=positions,
                                      window=0, mode=mode, cache=cache,
                                      cur_index=cur_index, mw=mw,
                                      layout=layout)
        if mode == "prefill":
            ks.append(k)
            vs.append(v)
        x = x + attn_out
        h = L.rms_norm(x, sh["ln2"], cfg.norm_eps)
        x = x + (L.ffn_apply(sh["mlp"], h) if mw is None
                 else mw.ffn(sh["mlp"], h, "mlp", cfg.d_ff))
    if train:
        out = None
    elif single:
        out = caches
    else:
        out = {"mamba": {k: torch.stack([st[k] for st in layers])
                         for k in mstate}}
        if ks:
            out["k"], out["v"] = torch.stack(ks), torch.stack(vs)
    if last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    unembed = L.unembed_apply if mw is None else mw.unembed
    return unembed(params["embed"], x), aux, out
