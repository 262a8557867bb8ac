"""Rematerialization policy: the port of ``repro.models.rematcfg``.

Each layer of a training forward runs under ``torch.utils.checkpoint``
(non-reentrant), as the reference wraps its scan body in
``jax.checkpoint``:

  minimal — nothing saved: the backward recomputes the whole layer from
            its input, kernel B4 included (the reference's
            ``nothing_saveable``). The default.
  dots    — the layer's 2-D matrix products (``aten.mm``: the projections
            and the FFN, ``x @ W`` on a [B, S, d] x) are saved and the
            rest recomputed, through a selective-checkpoint policy (the
            reference's ``dots_with_no_batch_dims_saveable``: products
            with batch dims, attention's, are recomputed).
  none    — no remat: autograd keeps every activation.

The reference keeps the policy in a module-level variable set by
``set_policy``; here the caller names it (``resolve``), so two models in
one process never share it.
"""
from __future__ import annotations

import functools
from typing import Callable, Union

import torch
from torch.utils import checkpoint as ckpt

POLICIES = ("minimal", "dots", "none")
DEFAULT = "minimal"


def resolve(remat: Union[bool, str]) -> str:
    """``True`` -> the default policy, ``False`` -> ``"none"``, a name as
    it is (the reference's ``remat`` flag and ``set_policy`` names)."""
    if remat is True:
        return DEFAULT
    if remat is False:
        return "none"
    if remat not in POLICIES:
        raise ValueError(f"remat policy {remat!r} is not one of {POLICIES}")
    return remat


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def wrap(fn: Callable, remat: Union[bool, str]) -> Callable:
    """``fn`` (one layer) under the policy ``remat`` names."""
    policy = resolve(remat)
    if policy == "none":
        return fn
    kw = {"use_reentrant": False, "preserve_rng_state": False}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(ckpt.checkpoint, fn, **kw)
