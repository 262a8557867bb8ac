"""Family dispatcher: the port of ``repro.models.model``.

    params            = init(cfg, seed=seed, device=device)
    logits, aux, _    = apply_train(params, cfg, batch, ctx=ctx)
    logits, _, kv     = apply_prefill(params, cfg, batch, ctx=ctx)
    logits, _, cache  = apply_decode(params, cfg, batch, cache, idx, ctx)
    loss, (ce, aux)   = loss_fn(params, cfg, batch, ctx=ctx, rows=B)

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

``apply_train``, ``loss_fn``, ``apply_prefill`` and ``apply_decode``
take ``ctx=None``: ``None`` or a
``single_device_ctx`` runs one device; a ctx with a DeviceMesh runs the
rank's blocks (``distributed/sharding.py``) through the family's mesh
path, for every family: ``transformer.forward`` (dense, moe, vlm,
audio), ``rwkv6.forward`` (ssm) and ``hybrid.forward`` (hybrid), in
training too, where ``loss_fn`` gives the rank's share of the loss.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, generator
from repro_torch.models import hybrid, rwkv6, transformer
from repro_torch.models.layers import (softmax_cross_entropy,
                                       vocab_parallel_nll)


def _mod(cfg: ModelConfig):
    if cfg.family == "ssm":
        return rwkv6
    if cfg.family == "hybrid":
        return hybrid
    return transformer


def init(cfg: ModelConfig, *, seed: int = 0,
         device: DeviceLike = None) -> dict:
    """Random params on ``device`` (default the CUDA card), drawn from a
    ``torch.Generator`` on that device seeded with ``seed``; on
    ``"meta"`` their shapes alone, nothing drawn."""
    return _mod(cfg).init(generator(device, seed), cfg)


def apply_train(params, cfg: ModelConfig, batch, remat=True, ctx=None):
    """The training forward: (logits [B, S, V], the MoE aux, None), each
    layer under the remat policy ``remat`` names (``models/rematcfg``).
    ``ctx`` with a DeviceMesh (every family): the rank's blocks of the
    params and its block of the batch (``data.pipeline.shard_batch``:
    the tokens, or musicgen's frame embeddings and labels, and the VLM's
    image embeddings), and its logits block ``[B_loc, S, V_loc]``."""
    return _mod(cfg).forward(params, cfg, batch, mode="train", remat=remat,
                             **_mesh_kw(ctx))


def loss_fn(params, cfg: ModelConfig, batch, remat=True, ctx=None,
            rows: Optional[int] = None):
    """Next-token cross-entropy + 0.01 x the MoE aux, and (ce, aux): the
    reference's. Targets are ``batch["labels"]`` where the batch has them
    (embeddings in: musicgen, on a mesh as on one device), else the
    tokens shifted by one.

    On a mesh (``ctx`` with a DeviceMesh) ``batch`` is the rank's block
    of a batch of ``rows`` rows (``data.pipeline.shard_batch``), and the
    three values are this rank's shares: summed over the dp axes they
    are the reference's loss, ce and aux (``distributed.compat``'s
    convention), and every rank of ``model`` holds the same share. The
    ce share is the rank's tokens' NLL sum over the whole batch's token
    count (``layers.vocab_parallel_nll`` on the vocabulary-sharded
    logits), or, where the batch does not split over the dp axes and
    every rank holds all of it, its mean over the dp size; the aux
    (replicated over the dp axes) shares alike."""
    logits, aux, _ = apply_train(params, cfg, batch, remat=remat, ctx=ctx)
    if "labels" in batch:
        labels, lg = batch["labels"], logits
    else:
        labels, lg = batch["tokens"][:, 1:], logits[:, :-1]
    if ctx is None or ctx.mesh is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
        ce = softmax_cross_entropy(lg, labels, mask)
        return ce + 0.01 * aux, (ce, aux)
    sharded = ctx.batch_sharded(rows)
    held = rows // ctx.dp_size if sharded else rows
    if labels.shape[0] != held:
        raise ValueError(f"the rank holds {labels.shape[0]} rows of a batch "
                         f"of {rows}; shard_batch lays out {held}")
    over = ctx.tp_axis if logits.shape[-1] != cfg.vocab_size else None
    ce = vocab_parallel_nll(lg, labels, ctx, over).sum() \
        / (rows * labels.shape[1])
    if not sharded:
        ce = ce / ctx.dp_size
    aux = aux / ctx.dp_size
    return ce + 0.01 * aux, (ce, aux)


def _mesh_kw(ctx) -> dict:
    return {} if ctx is None or ctx.mesh is None else {"ctx": ctx}


def apply_prefill(params, cfg: ModelConfig, batch, last_only: bool = False,
                  ctx=None):
    return _mod(cfg).forward(params, cfg, batch, mode="prefill",
                             last_only=last_only, **_mesh_kw(ctx))


def apply_decode(params, cfg: ModelConfig, batch, caches, cur_index: int,
                 ctx=None):
    return _mod(cfg).forward(params, cfg, batch, mode="decode",
                             caches=caches, cur_index=cur_index,
                             **_mesh_kw(ctx))


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
