"""Int8 gradient compression with error feedback for the multi-pod dp
axis: the port of ``repro.distributed.compression``.

Across pods the per-pod gradients must be averaged over a link far
thinner than the one inside a pod. The reduction is compressed:
``g + err`` is quantized to int8 by the whole leaf's blocks
(``optimizer.quantize_block``, BLOCK entries along the last axis with an
f32 absmax scale each), the int8 payloads and the scales are gathered
over ``pod``, each pod's is dequantized and they are summed in pod
order and divided by the pod count; what the quantization lost stays
behind as the next step's error feedback. The wire carries one byte an
entry and four a block of 128, about 3.9x fewer than an f32 all-reduce's
payload (the reference counts ~3.7x).

The reference runs this under a ``shard_map`` over ``pod`` only; here
each rank holds its block of each gradient (``distributed/sharding``),
and quantizes it by the whole leaf's blocks as the optimizer's int8
states do (``optimizer.Blocked``: a block that spans ranks of the axis
that shards the last dim takes its absmax as a pmax there), so that
every number is the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import compat
from repro_torch.distributed.meshctx import MeshCtx
from repro_torch.train.optimizer import (QTensor, blocked, dequantize_block,
                                         flatten, quantize_block, tree_map,
                                         unflatten)


def compressed_mean_tree(grads, err, ctx: MeshCtx, specs=None,
                         axis: str = "pod"):
    """The compressed mean over ``axis`` of each leaf of ``grads`` (the
    rank's blocks; ``specs`` their params' specs on a mesh), with the
    f32 error feedback ``err`` (the same tree). Returns (the means in
    the grads' dtypes, the new error state). ``compressed_mean_tree.
    record``, a list or None, takes each leaf's ``(g + err, its
    quantization, the mean)`` for checks."""
    n = ctx.shape[axis]
    spec_leaves = [s for _, s in flatten(specs)] if specs is not None \
        else [None] * len(flatten(grads))
    means, errs = [], []
    for (_, g), (_, e), spec in zip(flatten(grads), flatten(err),
                                    spec_leaves):
        gf = g.float() + e
        last = None if spec is None else blocked(tuple(g.shape), spec, ctx)
        qt = quantize_block(gf, last)
        new_e = gf - dequantize_block(qt)
        gq = compat.all_gather_axis(qt.q[None], ctx, axis, 0)     # int8 wire
        gs = compat.all_gather_axis(qt.scale[None], ctx, axis, 0)  # f32
        total = torch.zeros(gf.shape, dtype=torch.float32, device=gf.device)
        for i in range(n):
            total = total + dequantize_block(QTensor(
                q=gq[i], scale=gs[i], shape=qt.shape, last=qt.last))
        mean = total / n
        if compressed_mean_tree.record is not None:
            compressed_mean_tree.record.append((gf, qt, mean))
        mean = mean.to(g.dtype)
        means.append(mean)
        errs.append(new_e)
    return unflatten(grads, means), unflatten(err, errs)


compressed_mean_tree.record = None


def init_error_state(params):
    """f32 zeros in the params' tree (the rank's blocks on a mesh)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
