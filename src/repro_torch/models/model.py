"""Family dispatcher: the port of ``repro.models.model``.

    params            = init(cfg, seed=seed, device=device)
    logits, _, kv     = apply_prefill(params, cfg, batch)
    logits, _, cache  = apply_decode(params, cfg, batch, cache, idx)

Transformer families (``dense`` and ``moe`` run; ``transformer.
check_supported`` says what else raises); ``ssm`` (rwkv6) and ``hybrid``
(zamba2) raise ``NotImplementedError`` (ROADMAP A9).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import transformer


def _mod(cfg: ModelConfig):
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is "
                                  "not ported yet (ROADMAP A9)")
    return transformer


def init(cfg: ModelConfig, *, seed: int = 0,
         device: DeviceLike = None) -> dict:
    """Random params on ``device`` (default the CUDA card), drawn from a
    ``torch.Generator`` on that device seeded with ``seed``."""
    device = resolve(device)
    return _mod(cfg).init(torch.Generator(device=device).manual_seed(seed),
                          cfg)


def apply_prefill(params, cfg: ModelConfig, batch, last_only: bool = False):
    return _mod(cfg).forward(params, cfg, batch, mode="prefill",
                             last_only=last_only)


def apply_decode(params, cfg: ModelConfig, batch, caches, cur_index: int):
    return _mod(cfg).forward(params, cfg, batch, mode="decode",
                             caches=caches, cur_index=cur_index)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: DeviceLike = None):
    return _mod(cfg).init_cache(cfg, batch_size, max_len, device)
