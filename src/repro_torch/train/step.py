"""The train step: the port of ``repro.train.step``.

Value and gradient of ``models.model.loss_fn`` (with the reference's
microbatch accumulation), then ``optimizer.apply_updates``, which
updates params and optimizer state in place.

On a mesh (``ctx`` with a DeviceMesh, every family) the
params, gradients and states are the rank's blocks (``specs``: the
params', ``distributed.sharding``), the batch the rank's block
(``data.pipeline.shard_batch``), and the loss the rank's share
(``loss_fn``). The backward's collectives (``distributed.compat``) leave
each gradient summed over ``fsdp`` where its leaf's FSDP gather ran;
the step then sums it over the other dp axes. The pod axis has the
reference's two modes:

  - SPMD (the default): ``pod`` is one more dp axis, and each gradient
    is summed over it like the others. The sums are taken in f32 and
    rounded once to the gradient's dtype, as the reference's compiled
    step takes its gradient reductions in f32 (on the CPU, where the
    tests read its HLO);
  - compressed (``grad_compression`` on a mesh with a ``pod`` axis): each
    pod computes its own gradient on its rows of the batch (an inner ctx
    without ``pod`` in its dp axes), and the pods' gradients are
    averaged by ``distributed.compression``'s int8 reduction with error
    feedback. As the reference's (``out_specs=P()`` with
    ``check_vma=False``), the metrics are one pod's, pod 0's, not the
    batch's (ROADMAP C28).

Without a ``pod`` axis (one device included), ``grad_compression`` runs
the plain step, as the reference does.

Microbatches: microbatch i is rows ``[i·B/n, (i+1)·B/n)`` of the global
batch (on a mesh, the rank's block of those rows, as ``shard_batch``
lays them out for ``microbatches=n``); the gradients are accumulated in
f32 and averaged, and the reported loss and ce are the microbatches'
mean, aux 0, as the reference's scan reports them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.distributed import compat, compression
from repro_torch.distributed.meshctx import _names
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt_lib


def _on_mesh(ctx) -> bool:
    return ctx is not None and ctx.mesh is not None


def _grads_fn(tc: TrainConfig, cfg: ModelConfig, ctx=None, rows=None):
    """``compute(params, batch) -> (grads, {loss, ce, aux})``: the
    gradients of the loss (on a mesh, of the rank's share over a batch
    of ``rows`` rows a microbatch, summed over ``fsdp`` by the
    backward)."""
    mesh_kw = {"ctx": ctx, "rows": rows} if _on_mesh(ctx) else {}

    def value_and_grad(params, batch):
        leaves = [p for _, p in opt_lib.flatten(params)]
        loss, (ce, aux) = M.loss_fn(params, cfg, batch, remat=tc.remat,
                                    **mesh_kw)
        # a leaf the loss does not reach (musicgen's embedding table, when
        # embeddings come in) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), ce.detach(), aux.detach(), grads

    def compute(params, batch):
        if tc.microbatches <= 1:
            loss, ce, aux, grads = value_and_grad(params, batch)
            return opt_lib.unflatten(params, grads), \
                {"loss": loss, "ce": ce, "aux": aux}
        n = tc.microbatches
        gacc, lacc = None, torch.zeros((), dtype=torch.float32)
        for i in range(n):
            mbatch = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
            loss, _, _, g = value_and_grad(params, mbatch)
            g = [t.float() for t in g]
            gacc = g if gacc is None else [a + b for a, b in zip(gacc, g)]
            lacc = lacc.to(loss.device) + loss
        grads = [g / n for g in gacc]
        # as the reference's scan reports them: ce is the mean loss, and
        # aux is not accumulated
        return opt_lib.unflatten(params, grads), {
            "loss": lacc / n, "ce": lacc / n,
            "aux": torch.zeros((), dtype=torch.float32, device=lacc.device)}
    return compute


def dp_summed(grads, ctx, specs, dp_axes):
    """Each gradient block summed over the axes of ``dp_axes`` that its
    leaf's FSDP gather did not already sum it over, in f32 and rounded
    once to its dtype: one all-reduce a set of axes, over the leaves'
    blocks laid end to end in ``flatten``'s order."""
    flat = opt_lib.flatten(grads)
    spec_leaves = [s for _, s in opt_lib.flatten(specs)]
    groups = {}
    for i, ((_, g), spec) in enumerate(zip(flat, spec_leaves)):
        held = {a for e in spec for a in _names(e)}
        axes = tuple(a for a in dp_axes
                     if not (a == ctx.fsdp_axis and a in held))
        groups.setdefault(axes, []).append(i)
    out = [g for _, g in flat]
    for axes in sorted(groups):
        idx = groups[axes]
        if ctx.axes_size(axes) == 1:
            continue
        buf = torch.cat([out[i].float().reshape(-1) for i in idx])
        buf = compat.all_reduce_axis(buf, ctx, axes)
        at = 0
        for i in idx:
            n = out[i].numel()
            out[i] = buf[at:at + n].view(out[i].shape).to(out[i].dtype)
            at += n
    return opt_lib.unflatten(grads, out)


def _metrics_summed(metrics, ctx, dp_axes):
    """The shares of loss, ce and aux summed over ``dp_axes``."""
    keys = ("loss", "ce", "aux")
    v = torch.stack([metrics[k].float() for k in keys])
    v = compat.all_reduce_axis(v, ctx, dp_axes)
    return {k: v[i] for i, k in enumerate(keys)}


def _pod_rows(batch, ctx, inner, rows):
    """The rank's rows of its pod's block of a batch of ``rows`` rows,
    from what ``shard_batch`` gave it on ``ctx``: its block over (pod,
    data) where the batch splits there (the same rows), else the whole
    batch, cut here to the pod's block and then, where that splits,
    ``inner``'s block of it."""
    if ctx.batch_sharded(rows):
        return batch
    per_pod = rows // ctx.shape["pod"]
    out = {}
    for k, v in batch.items():
        v = v[ctx.block(rows, "pod")]
        out[k] = v[inner.block(per_pod, inner.dp_axes)] \
            if inner.batch_sharded(per_pod) else v
    return out


def make_train_step(tc: TrainConfig, cfg: ModelConfig, ctx=None,
                    specs=None):
    """``train_step(params, opt_state, batch, err=None) -> (params,
    opt_state, metrics)``: params, opt_state and the error feedback
    ``err`` (``compression.init_error_state``; compressed mode only) are
    updated in place (params and opt_state also returned); metrics are
    0-d tensors on the device: loss, ce, aux, lr and grad_norm (before
    clipping). Every param leaf must require grad (``Trainer`` sets
    it). ``ctx`` with a DeviceMesh: the rank's blocks, their ``specs``
    (the params'), and the rank's block of a batch of
    ``tc.global_batch`` rows."""
    if not _on_mesh(ctx):
        compute = _grads_fn(tc, cfg)

        def train_step(params, opt_state, batch, err=None):
            grads, metrics = compute(params, batch)
            params, opt_state, om = opt_lib.apply_updates(
                tc.opt, params, grads, opt_state)
            metrics.update(om)
            return params, opt_state, metrics
        return train_step

    if specs is None:
        raise ValueError("a train step on a mesh needs the params' specs")
    n = max(tc.microbatches, 1)
    rows = tc.global_batch // n
    compress = tc.opt.grad_compression and "pod" in ctx.shape
    if not compress:
        compute = _grads_fn(tc, cfg, ctx, rows)
        dp_axes = ctx.dp_axes
    else:
        inner = dataclasses.replace(
            ctx, dp_axes=tuple(a for a in ctx.dp_axes if a != "pod"))
        pods = ctx.shape["pod"]
        if rows % pods:
            raise ValueError(f"a microbatch of {rows} rows does not split "
                             f"over the {pods} pods")
        compute = _grads_fn(tc, cfg, inner, rows // pods)
        dp_axes = inner.dp_axes

    def train_step(params, opt_state, batch, err=None):
        if compress:
            batch = _pod_rows(batch, ctx, inner, rows)
        grads, metrics = compute(params, batch)
        grads = dp_summed(grads, ctx, specs, dp_axes)
        metrics = _metrics_summed(metrics, ctx, dp_axes)
        if compress:
            # one pod's metrics, as the reference reports them (C28)
            metrics = {k: compat.all_gather_axis(v[None], ctx, "pod", 0)[0]
                       for k, v in metrics.items()}
            if err is None:
                raise ValueError("the compressed step needs the error "
                                 "feedback (compression.init_error_state)")
            grads, new_err = compression.compressed_mean_tree(
                grads, err, ctx, specs)
            for (_, e), (_, ne) in zip(opt_lib.flatten(err),
                                       opt_lib.flatten(new_err)):
                e.copy_(ne)
        params, opt_state, om = opt_lib.apply_updates(
            tc.opt, params, grads, opt_state, ctx, specs)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step
