"""Stand-ins for every model input: the port of ``repro.launch.specs``.

The reference's are ``jax.ShapeDtypeStruct``s; the port's are tensors on
the meta device (``torch.empty(..., device="meta")``): a shape and a
dtype, no storage, which the dry run (``launch/dryrun.py``) feeds its
steps. The shapes are the reference's. The dtypes map from the
reference's one for one, each to the dtype the port's own inputs take:

  ========================  ======================================
  the reference             the port
  ========================  ======================================
  int32 ids and labels      ``torch.int32`` (the port's token ids)
  bfloat16 embeddings       ``torch.bfloat16``
  int32 ``cur_index``       ``torch.int32``, a 0-d tensor
  the cache's leaves        as ``model.init_cache`` makes them
  ========================  ======================================

``cache_struct`` is ``model.init_cache`` on the meta device, so its tree
is the port's: the VLM's self caches flat, ``[n_layers, B, S, KV,
hd]``, where the reference's are ``[n_sb, per, B, S, KV, hd]``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import model as M

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, batch: int, seq: int
                ) -> Dict[str, torch.Tensor]:
    """A batch of ``batch`` rows of ``seq`` positions: ``tokens`` int32,
    or with ``embeds_input`` bf16 ``embeds`` and int32 ``labels``; the
    VLM's bf16 ``image_embeds`` besides."""
    s = {}
    if cfg.embeds_input:
        s["embeds"] = _spec((batch, seq, cfg.d_model), torch.bfloat16)
        s["labels"] = _spec((batch, seq), torch.int32)
    else:
        s["tokens"] = _spec((batch, seq), torch.int32)
    if cfg.family == "vlm":
        s["image_embeds"] = _spec((batch, cfg.n_image_tokens, cfg.d_model),
                                  torch.bfloat16)
    return s


def cache_struct(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """``model.init_cache`` on the meta device: the decode cache's tree of
    shapes and dtypes, nothing allocated."""
    return M.init_cache(cfg, batch, max_len, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """What the step of ``shape.kind`` takes: ``{"batch"}`` for train and
    prefill; for decode one new token's batch, the ``cache`` of
    ``shape.seq_len`` positions and ``cur_index``."""
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_specs(cfg, shape.global_batch, shape.seq_len)}
    return {"batch": batch_specs(cfg, shape.global_batch, 1),
            "cache": cache_struct(cfg, shape.global_batch, shape.seq_len),
            "cur_index": _spec((), torch.int32)}
