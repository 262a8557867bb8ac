"""Carry corpus state and LM weights from the JAX package into the port.

Data takes the place of weights in the search engine: to hold the two
packages against each other they must score the same corpus.
``from_reference`` takes the reference's corpus state, duck-typed and
without importing it, and returns the port's:

  - a corpus (anything with ``ids``, ``vals``, ``norms``, ``doc_ids``,
    numpy or array-like) -> ``repro_torch.core.corpus.Corpus`` (host);
  - a 1-D packed uint32 Fig. 8 stream -> the same stream as numpy uint32;
  - a packed tile matrix (2-D uint32, or a slab with ``.tiles``) ->
    ``PackedSlab`` on ``device`` (int32 view of the words).

``lm_params_from_reference`` does the same for the LM stack's params,
and ``opt_state_from_reference`` for AdamW's state (f32 or int8 m and
v), so that a reference checkpoint restores into the port: both take
numpy arrays or the CPU tensors that ``repro_torch.checkpoint``'s
``CheckpointManager.restore(step)`` returns for a reference directory.
"""
from __future__ import annotations

from typing import Any, Mapping, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.corpus import Corpus
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels.fused import PackedSlab
from repro_torch.models.transformer import check_supported


def from_reference(state, device: DeviceLike = None
                   ) -> Union[Corpus, np.ndarray, PackedSlab]:
    """The port's counterpart of one piece of the reference's corpus
    state (see the module docstring). Arrays are copied; ``device`` is
    used only for tile matrices."""
    if all(hasattr(state, f) for f in ("ids", "vals", "norms", "doc_ids")):
        return Corpus(np.array(state.doc_ids, np.int64),
                      np.array(state.ids, np.int32),
                      np.array(state.vals, np.float32),
                      np.array(state.norms, np.float32))
    tiles = getattr(state, "tiles", None)
    arr = np.asarray(state if tiles is None else tiles)
    if arr.dtype != np.uint32:
        raise TypeError(f"expected a corpus, or packed uint32 words; got "
                        f"{type(state).__name__} of {arr.dtype}")
    if arr.ndim == 1 and tiles is None:
        return arr.copy()
    if arr.ndim == 2:
        words = np.ascontiguousarray(arr).view(np.int32).copy()
        return PackedSlab(torch.from_numpy(words).to(resolve(device)))
    raise ValueError(f"packed words must be a 1-D stream or a 2-D tile "
                     f"matrix, got shape {arr.shape}")


def _tensor(arr, device: torch.device) -> torch.Tensor:
    """A numpy array (or a tensor) as a tensor of the same dtype and bits,
    copied; bfloat16 (numpy's ml_dtypes extension type) goes through its
    int16 bits."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device, copy=True)
    arr = np.array(arr, order="C")          # a copy; 0-d stays 0-d
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def lm_params_from_reference(params: Mapping[str, Any], cfg: ModelConfig,
                             device: DeviceLike = None, ctx=None) -> dict:
    """The reference's LM param tree, as numpy arrays (``jax.tree.map(
    np.asarray, params)``), as the port's params on ``device``. Every
    stack of layers becomes one dict a layer, in layer order:

      - transformers: the ``[n, ...]`` stacks of ``blocks`` (dense and
        audio), or of ``dense_blocks`` (kimi-k2's leading dense layers)
        followed by ``moe_blocks`` (router, experts, the shared expert
        where there is one), as ``"blocks"``; the VLM's ``self_blocks``
        as ``"blocks"`` and its ``cross_blocks`` as ``"cross_blocks"``;
      - ``ssm`` (rwkv6): ``blocks`` (``ln1``, ``ln2``, ``tm``, ``cm``) as
        ``"blocks"``;
      - ``hybrid`` (zamba2): the ``mamba`` stack as ``"mamba"``; the
        ``shared_attn`` block stays one dict.

    Every array keeps its dtype and bits (f32 biases, norms, qk-norm
    scales, router, lerp coefficients, decays, ``conv_w``, ``A_log``,
    ``D`` and ``dt_bias``; weights in the config's dtype) and its ``x @
    W`` orientation.

    ``ctx`` with a DeviceMesh: this rank's blocks of them
    (``sharding.shard_params``), on ``device`` (default the ctx's); the
    whole tree is laid out on the host first."""
    if ctx is not None and ctx.mesh is not None:
        from repro_torch.distributed import sharding
        whole = _unstacked(params, cfg, torch.device("cpu"))
        return sharding.shard_params(whole, cfg, ctx, None if device is None
                                     else resolve(device))
    return _unstacked(params, cfg, resolve(device))


def opt_state_from_reference(state: Mapping[str, Any], cfg: ModelConfig,
                             device: DeviceLike = None) -> dict:
    """The reference's AdamW state ``{"step", "m", "v"}`` (numpy arrays,
    or CPU tensors from a checkpoint; m and v f32 or the reference's
    QTensors) as the port's (``repro_torch.train.optimizer``), on
    ``device``: m and v take the params' layout as
    ``lm_params_from_reference`` lays them out. A QTensor of a stack
    ``[n, ...]`` becomes one a layer: its blocks run along the last axis,
    so layer i's payload and scales are the stack's ``[i]``."""
    device = resolve(device)
    return {"step": _leaf(state["step"], None, device),
            "m": _unstacked(state["m"], cfg, device),
            "v": _unstacked(state["v"], cfg, device)}


def _leaf(x, index, device: torch.device):
    """One leaf (an array, a tensor, or a QTensor of either), or its
    ``[index]`` (one layer of a stack), as the port's on ``device``."""
    if hasattr(x, "q") and hasattr(x, "scale"):
        from repro_torch.train.optimizer import QTensor
        shape = tuple(x.shape)
        return QTensor(q=_leaf(x.q, index, device),
                       scale=_leaf(x.scale, index, device),
                       shape=shape if index is None else shape[1:])
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return _tensor(x if index is None else x[index], device)


def _unstacked(params: Mapping[str, Any], cfg: ModelConfig,
               device: torch.device) -> dict:
    """The reference's tree (of params, or of m or v) in the port's
    layout on ``device``."""
    def conv(tree, index=None):
        if isinstance(tree, Mapping):
            return {k: conv(v, index) for k, v in tree.items()}
        return _leaf(tree, index, device)

    def n_stacked(x):
        x = getattr(x, "q", x)       # a QTensor's payload has its shape
        return (x if isinstance(x, torch.Tensor) else np.asarray(x)).shape[0]

    def unstack(names, first_leaf, n=cfg.n_layers):
        layers = [conv(params[name], i) for name in names if name in params
                  for i in range(n_stacked(params[name][first_leaf]))]
        if len(layers) != n:
            raise ValueError(f"{len(layers)} stacked layers in "
                             f"{' + '.join(names)}, config has {n}")
        return layers

    out = {"embed": conv(params["embed"]),
           "final_norm": conv(params["final_norm"])}
    if cfg.family == "ssm":
        out["blocks"] = unstack(("blocks",), "ln1")
    elif cfg.family == "hybrid":
        out["mamba"] = unstack(("mamba",), "norm")
        out["shared_attn"] = conv(params["shared_attn"])
    elif cfg.family == "vlm":
        check_supported(cfg)
        out["blocks"] = unstack(("self_blocks",), "ln1")
        out["cross_blocks"] = unstack(("cross_blocks",), "ln1",
                                      cfg.n_layers // cfg.cross_attn_every)
    else:
        check_supported(cfg)
        out["blocks"] = unstack(("dense_blocks", "moe_blocks")
                                if cfg.n_experts > 0 else ("blocks",), "ln1")
    return out
