"""LM serving steps: prefill, decode, a sampler and the generation loop.

The port of ``repro.serve.step``. PyTorch runs eagerly, so the
``make_*`` functions return plain closures where the reference returns
jitted ones, and the decode cache is updated in place where the
reference donates it.

On a mesh (a ``ctx`` with a DeviceMesh; the dense and moe families)
every rank runs the same calls in lockstep on its blocks. The decode
cache is laid out by ``cache_specs``: the batch over ``dp_axes`` where
it divides, else the sequence over ``fsdp``; kv heads over ``model``
where they divide, else the sequence over ``model`` too (flash-decoding,
``layers.decode_attention``). The logits leave the model sharded over
``model`` on the vocabulary, as the reference's constraint ``P(dp, None,
tp)`` has them, and ``generate`` gathers them over ``model`` before
``sample``, so ``argmax`` keeps the lowest index among equal maxima;
the sampled tokens are gathered over the dp axes, so every rank feeds
the whole batch to the next step and returns the whole ``[B, max_new]``.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed import compat, sharding
from repro_torch.models import model as M


def _on_mesh(ctx) -> bool:
    return ctx is not None and ctx.mesh is not None


def cache_specs(cfg: ModelConfig, ctx, batch_size: int) -> dict:
    """Specs (``distributed/sharding.py``'s tuples) for the decode cache
    tree of ``cfg``'s family, the reference's rule for rule: kv heads
    over ``model`` when they divide, else the cache's sequence over
    ``model`` instead (flash-decoding); the batch over ``dp_axes`` when
    it divides, else the sequence over ``fsdp`` (with ``model``, the
    two as one entry, ``fsdp`` major). The recurrent states shard their
    batch and heads. The VLM's self caches are the port's flat
    ``[n_layers, B, S, KV, hd]`` (the reference's ``[n_sb, per, ...]``
    with its superblock axes merged)."""
    tp, dp = ctx.tp_axis, sharding.entry(ctx.dp_axes)
    ts = ctx.shape[tp]
    kv_tp = tp if cfg.n_kv_heads % ts == 0 else None
    batch_shardable = ctx.batch_sharded(batch_size)
    bdp = dp if batch_shardable else None

    def kv_spec(ndim, seq_axis, batch_axis, head_axis):
        spec = [None] * ndim
        if batch_shardable:
            spec[batch_axis] = dp
        else:
            spec[seq_axis] = ctx.fsdp_axis   # SP: shard the sequence instead
        spec[head_axis] = kv_tp
        if kv_tp is None:                    # seq over model instead of heads
            spec[seq_axis] = tp if spec[seq_axis] is None \
                else (spec[seq_axis], tp)
        return tuple(spec)

    if cfg.family == "ssm":
        return {"wkv": (None, bdp, tp, None, None),
                "tm_x": (None, bdp, None), "cm_x": (None, bdp, None)}
    if cfg.family == "hybrid":
        return {"mamba": {"h": (None, bdp, tp, None, None),
                          "conv": (None, bdp, None, None)},
                "k": kv_spec(5, 2, 1, 3), "v": kv_spec(5, 2, 1, 3)}
    spec = {"k": kv_spec(5, 2, 1, 3), "v": kv_spec(5, 2, 1, 3)}
    if cfg.family == "vlm":
        spec.update(img_k=kv_spec(5, 2, 1, 3), img_v=kv_spec(5, 2, 1, 3))
    return spec


def make_prefill(cfg: ModelConfig, ctx=None):
    """prefill(params, batch) -> (last-position logits [B, 1, V], kv); on
    a mesh the rank's blocks, the logits ``[B_loc, 1, V/M]``."""
    def prefill(params, batch):
        logits, _, kv = M.apply_prefill(params, cfg, batch, last_only=True,
                                        ctx=ctx)
        return logits, kv
    return prefill


def make_decode_step(cfg: ModelConfig, ctx=None):
    """decode(params, step_batch, cache, cur_index) -> (logits [B, 1, V],
    cache); the cache is written in place. On a mesh the rank's blocks."""
    def decode(params, step_batch, cache, cur_index):
        logits, _, cache = M.apply_decode(params, cfg, step_batch, cache,
                                          cur_index, ctx=ctx)
        return logits, cache
    return decode


def _mesh_cache(cfg: ModelConfig, kv: dict, batch_size: int, S: int,
                max_len: int, ctx) -> dict:
    """The rank's block of the decode cache (``cache_specs``) after a
    prefill of ``S`` positions whose kv is the rank's (its batch block
    and kv heads, every position)."""
    seq = ctx.block(max_len, cache_specs(cfg, ctx, batch_size)["k"][2])
    cache = {}
    for name in ("k", "v"):
        t = kv[name]
        blk = torch.zeros((t.shape[0], t.shape[1], seq.stop - seq.start,
                           *t.shape[3:]), dtype=t.dtype, device=t.device)
        hi = min(seq.stop, S)
        if hi > seq.start:
            blk[:, :, :hi - seq.start] = t[:, :, seq.start:hi]
        cache[name] = blk
    return cache


def decode_cache(cfg: ModelConfig, kv: dict, batch_size: int, S: int,
                 max_len: int, device: DeviceLike = None,
                 ctx=None) -> dict:
    """The decode cache after a prefill of ``S`` positions whose third
    result is ``kv``: for ``ssm`` the prefill's state itself; for
    ``hybrid`` its Mamba state as it is, and its k and v copied into a
    cache of ``max_len`` positions (ROADMAP C20: the reference hands the
    prompt-sized cache on, and its decode writes clamp onto position
    S-1); for the transformer families the k and v so copied, and the
    VLM's image k and v (``img_k``, ``img_v``) as they are, in their own
    dtype, as the reference hands them on. On a mesh, the rank's block
    of it (``cache_specs``; ``max_len`` a multiple of the sequence's
    shards)."""
    if _on_mesh(ctx):
        return _mesh_cache(cfg, kv, batch_size, S, max_len, ctx)
    if cfg.family == "ssm":
        return kv
    cache = M.init_cache(cfg, batch_size, max_len, device, image_kv=kv)
    if cfg.family == "hybrid":
        cache["mamba"] = kv["mamba"]
    if "k" in kv:                   # a hybrid with no site holds none
        cache["k"][:, :, :S] = kv["k"]
        cache["v"][:, :, :S] = kv["v"]
    return cache


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0) -> torch.Tensor:
    """logits: [B, 1, V] -> token ids [B, 1] int32. Greedy (the first of
    equal maxima, as ``jnp.argmax``) at temperature 0, else a draw from
    softmax(logits / temperature) with ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits[:, 0].float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _whole(logits: torch.Tensor, cfg: ModelConfig, ctx) -> torch.Tensor:
    """The rank's logits gathered over ``model`` on the vocabulary."""
    if logits.shape[-1] == cfg.vocab_size:
        return logits
    return compat.all_gather_axis(logits, ctx, ctx.tp_axis, dim=-1)


def _batch_whole(t: torch.Tensor, ctx, batch_size: int) -> torch.Tensor:
    """The rank's batch block gathered over the dp axes (inner first)."""
    if not ctx.batch_sharded(batch_size):
        return t
    for axis in reversed(ctx.dp_axes):
        t = compat.all_gather_axis(t, ctx, axis, dim=0)
    return t


def generate(params, cfg: ModelConfig, prompt, max_new: int, max_len: int,
             temperature: float = 0.0, seed: int = 0,
             device: DeviceLike = None,
             stats: Optional[dict] = None,
             image_embeds: Optional[torch.Tensor] = None, ctx=None,
             logits: Optional[list] = None) -> torch.Tensor:
    """Prefill ``prompt`` [B, S] (ints), then decode ``max_new`` tokens:
    [B, max_new] int32 on ``device`` (default the CUDA card, where
    ``params`` must lie). The cache holds ``max_len`` positions. If
    ``stats`` is a dict it receives ``prefill_s`` (prefill and the first
    token) and ``decode_s`` (the other ``max_new - 1``), host clock, each
    ending with the card synchronized; while ``compat.stats`` counts the
    collectives, also ``collectives_prefill``, a copy of its counts when
    the prefill (and the first token) ended.

    The VLM needs ``image_embeds`` [B, n_image_tokens, d], which go into
    the prefill batch; without them it raises ``ValueError`` before any
    work on the card (ROADMAP C21: the reference's ``generate`` prefills
    on the tokens alone, and its VLM raises ``KeyError`` there). Other
    families take none.

    ``ctx`` with a DeviceMesh: ``params`` are the rank's blocks on the
    ctx's device (``device`` is ignored), every rank passes the whole
    prompt and gets the whole tokens; the cache's sequence rounds up to
    a multiple of its shards (the positions past ``max_len`` are never
    attended). ``logits``: a list that receives each step's logits
    ``[B, 1, V]``, whole (gathered over the dp axes on a mesh), for
    checks."""
    mesh = _on_mesh(ctx)
    if mesh:
        sharding.check_family(cfg)
    device = ctx.device if mesh else resolve(device)
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=device)
    B, S = prompt.shape
    if S + max_new - 1 > max_len:
        raise ValueError(f"{S} prompt + {max_new} new tokens need a cache "
                         f"of {S + max_new - 1} positions, got {max_len}")
    if (cfg.family == "vlm") != (image_embeds is not None):
        raise ValueError(
            f"{cfg.name}: generate(image_embeds=...) is for the vlm family "
            "alone, and the vlm family needs it (ROADMAP C21)")
    batch = {"tokens": prompt}
    if image_embeds is not None:
        batch["image_embeds"] = torch.as_tensor(image_embeds, device=device)
    if mesh:
        shards = ctx.axes_size(cache_specs(cfg, ctx, B)["k"][2])
        max_len = -(-max_len // shards) * shards
    prefill, decode = make_prefill(cfg, ctx), make_decode_step(cfg, ctx)
    gen = torch.Generator(device=device).manual_seed(seed)

    def step_tokens(step_logits):
        if mesh:
            step_logits = _whole(step_logits, cfg, ctx)
        if logits is not None:
            logits.append(_batch_whole(step_logits, ctx, B) if mesh
                          else step_logits)
        t = sample(step_logits, gen, temperature)
        return _batch_whole(t, ctx, B) if mesh else t

    t0 = time.perf_counter()
    step_logits, kv = prefill(params, batch)
    cache = decode_cache(cfg, kv, B, S, max_len, device, ctx=ctx)
    del kv
    toks = [step_tokens(step_logits)]
    if stats is not None:
        _sync(device)
        t1 = time.perf_counter()
        if compat.stats is not None:
            stats["collectives_prefill"] = dict(compat.stats)
    for i in range(max_new - 1):
        step_logits, cache = decode(params, {"tokens": toks[-1]}, cache,
                                    S + i)
        toks.append(step_tokens(step_logits))
    out = torch.cat(toks, dim=1)
    if stats is not None:
        _sync(device)
        stats["prefill_s"] = t1 - t0
        stats["decode_s"] = time.perf_counter() - t1
    return out
