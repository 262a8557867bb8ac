"""LM serving steps: prefill, decode, a sampler and the generation loop.

The port of ``repro.serve.step`` on one card. The reference's
``cache_specs`` (mesh sharding of the cache) waits for the multi-device
port (ROADMAP A8). PyTorch runs eagerly, so the ``make_*`` functions
return plain closures where the reference returns jitted ones, and the
decode cache is updated in place where the reference donates it.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import model as M


def make_prefill(cfg: ModelConfig):
    """prefill(params, batch) -> (last-position logits [B, 1, V], kv)."""
    def prefill(params, batch):
        logits, _, kv = M.apply_prefill(params, cfg, batch, last_only=True)
        return logits, kv
    return prefill


def make_decode_step(cfg: ModelConfig):
    """decode(params, step_batch, cache, cur_index) -> (logits [B, 1, V],
    cache); the cache is written in place."""
    def decode(params, step_batch, cache, cur_index):
        logits, _, cache = M.apply_decode(params, cfg, step_batch, cache,
                                          cur_index)
        return logits, cache
    return decode


def decode_cache(cfg: ModelConfig, kv: dict, batch_size: int, S: int,
                 max_len: int, device: DeviceLike = None) -> dict:
    """The decode cache after a prefill of ``S`` positions whose third
    result is ``kv``: for ``ssm`` the prefill's state itself; for
    ``hybrid`` its Mamba state as it is, and its k and v copied into a
    cache of ``max_len`` positions (ROADMAP C20: the reference hands the
    prompt-sized cache on, and its decode writes clamp onto position
    S-1); for the transformer families the k and v so copied, and the
    VLM's image k and v (``img_k``, ``img_v``) as they are, in their own
    dtype, as the reference hands them on."""
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


def generate(params, cfg: ModelConfig, prompt, max_new: int, max_len: int,
             temperature: float = 0.0, seed: int = 0,
             device: DeviceLike = None,
             stats: Optional[dict] = None,
             image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill ``prompt`` [B, S] (ints), then decode ``max_new`` tokens:
    [B, max_new] int32 on ``device`` (default the CUDA card, where
    ``params`` must lie). The cache holds ``max_len`` positions. If
    ``stats`` is a dict it receives ``prefill_s`` (prefill and the first
    token) and ``decode_s`` (the other ``max_new - 1``), host clock, each
    ending with the card synchronized.

    The VLM needs ``image_embeds`` [B, n_image_tokens, d], which go into
    the prefill batch; without them it raises ``ValueError`` before any
    work on the card (ROADMAP C21: the reference's ``generate`` prefills
    on the tokens alone, and its VLM raises ``KeyError`` there). Other
    families take none."""
    device = resolve(device)
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
    prefill, decode = make_prefill(cfg), make_decode_step(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    logits, kv = prefill(params, batch)
    cache = decode_cache(cfg, kv, B, S, max_len, device)
    del kv
    toks = [sample(logits, gen, temperature)]
    if stats is not None:
        _sync(device)
        t1 = time.perf_counter()
    for i in range(max_new - 1):
        logits, cache = decode(params, {"tokens": toks[-1]}, cache, S + i)
        toks.append(sample(logits, gen, temperature))
    out = torch.cat(toks, dim=1)
    if stats is not None:
        _sync(device)
        stats["prefill_s"] = t1 - t0
        stats["decode_s"] = time.perf_counter() - t1
    return out
