"""The train step on one device: the port of ``repro.train.step``.

Value and gradient of ``models.model.loss_fn`` (with the reference's
microbatch accumulation), then ``optimizer.apply_updates``, which
updates params and optimizer state in place. The reference's pod modes
(the SPMD gradient all-reduce, and the int8 compressed reduction under
``shard_map``) need a mesh, which one card does not have:
``grad_compression=True`` raises (ROADMAP A8).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt_lib


def _grads_fn(tc: TrainConfig, cfg: ModelConfig):
    def value_and_grad(params, batch):
        leaves = [p for _, p in opt_lib.flatten(params)]
        loss, (ce, aux) = M.loss_fn(params, cfg, batch, remat=tc.remat)
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


def make_train_step(tc: TrainConfig, cfg: ModelConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: params and opt_state are updated in place (and returned);
    metrics are 0-d tensors on the device: loss, ce, aux, lr and
    grad_norm (before clipping). Every param leaf must require grad
    (``Trainer`` sets it)."""
    if tc.opt.grad_compression:
        raise NotImplementedError(
            "grad_compression is the reference's int8 pod all-reduce, which "
            "needs a mesh: not ported (ROADMAP A8)")
    compute = _grads_fn(tc, cfg)

    def train_step(params, opt_state, batch):
        grads, metrics = compute(params, batch)
        params, opt_state, om = opt_lib.apply_updates(tc.opt, params, grads,
                                                      opt_state)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step
