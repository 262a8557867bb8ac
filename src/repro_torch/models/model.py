"""Family dispatcher: the port of ``repro.models.model``.

    params            = init(cfg, seed=seed, device=device)
    logits, aux, _    = apply_train(params, cfg, batch)
    logits, _, kv     = apply_prefill(params, cfg, batch, ctx=ctx)
    logits, _, cache  = apply_decode(params, cfg, batch, cache, idx, ctx)
    loss, (ce, aux)   = loss_fn(params, cfg, batch)

Transformer families (``dense``, ``moe``, ``vlm`` and ``audio``,
``models/transformer.py``), ``ssm`` (rwkv6, ``models/rwkv6.py``) and
``hybrid`` (zamba2, ``models/hybrid.py``). A prefill's third result is
what its family carries into decode: every layer's k and v
(transformers; the VLM adds its cross layers' image k and v), the
recurrent state (ssm), or the Mamba state and every site's k and v
(hybrid); ``serve.step.generate`` turns it into a decode cache. Training
(``apply_train``, ``loss_fn``) runs every family, each layer under the
remat policy ``remat`` names (the hybrid's shared block excepted, as in
the reference).

``apply_prefill`` and ``apply_decode`` take ``ctx=None``: ``None`` or a
``single_device_ctx`` runs one device; a ctx with a DeviceMesh runs the
rank's blocks (``distributed/sharding.py``) for the dense and moe
families (``transformer.forward``'s mesh path) and raises
``NotImplementedError`` naming ROADMAP A8.5 for the others.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed import sharding
from repro_torch.models import hybrid, rwkv6, transformer
from repro_torch.models.layers import softmax_cross_entropy


def _mod(cfg: ModelConfig):
    if cfg.family == "ssm":
        return rwkv6
    if cfg.family == "hybrid":
        return hybrid
    return transformer


def init(cfg: ModelConfig, *, seed: int = 0,
         device: DeviceLike = None) -> dict:
    """Random params on ``device`` (default the CUDA card), drawn from a
    ``torch.Generator`` on that device seeded with ``seed``."""
    device = resolve(device)
    return _mod(cfg).init(torch.Generator(device=device).manual_seed(seed),
                          cfg)


def apply_train(params, cfg: ModelConfig, batch, remat=True):
    """The training forward: (logits [B, S, V], the MoE aux, None), each
    layer under the remat policy ``remat`` names (``models/rematcfg``)."""
    return _mod(cfg).forward(params, cfg, batch, mode="train", remat=remat)


def loss_fn(params, cfg: ModelConfig, batch, remat=True):
    """Next-token cross-entropy + 0.01 x the MoE aux, and (ce, aux): the
    reference's. Targets are ``batch["labels"]`` where the batch has them
    (embeddings in: musicgen), else the tokens shifted by one."""
    logits, aux, _ = apply_train(params, cfg, batch, remat=remat)
    if "labels" in batch:
        labels, lg = batch["labels"], logits
    else:
        labels, lg = batch["tokens"][:, 1:], logits[:, :-1]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    ce = softmax_cross_entropy(lg, labels, mask)
    return ce + 0.01 * aux, (ce, aux)


def _mesh_kw(cfg: ModelConfig, ctx) -> dict:
    if ctx is None or ctx.mesh is None:
        return {}
    sharding.check_family(cfg)
    return {"ctx": ctx}


def apply_prefill(params, cfg: ModelConfig, batch, last_only: bool = False,
                  ctx=None):
    return _mod(cfg).forward(params, cfg, batch, mode="prefill",
                             last_only=last_only, **_mesh_kw(cfg, ctx))


def apply_decode(params, cfg: ModelConfig, batch, caches, cur_index: int,
                 ctx=None):
    return _mod(cfg).forward(params, cfg, batch, mode="decode",
                             caches=caches, cur_index=cur_index,
                             **_mesh_kw(cfg, ctx))


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: DeviceLike = None, image_kv: Optional[dict] = None):
    """A zeroed decode cache: the recurrent state for ``ssm`` (which needs
    no length), else one of ``max_len`` positions; the VLM's takes the
    image k and v of ``image_kv`` (a prefill's cache) where it is
    given."""
    if cfg.family == "ssm":
        return rwkv6.init_state(cfg, batch_size, device=device)
    if cfg.family == "vlm":
        return transformer.init_cache(cfg, batch_size, max_len, device,
                                      image_kv)
    return _mod(cfg).init_cache(cfg, batch_size, max_len, device)
