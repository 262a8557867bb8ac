"""The ranks of ``tests/test_torch_perf_mesh.py``: a gloo world of 8
ranks on a 2 x 4 ``("data", "model")`` mesh (``run``: a spawn,
a ``FileStore`` under the test's directory), each importing
torch and ``repro_torch`` only. Each rank sets every case's perf flags
itself (``models/perfcfg`` is a process's state), carries the case's
weights in as its blocks, and finds the whole prefill logits and the
gradients of ``loss_fn`` summed over the dp axes (rank 0 keeps them),
and the collectives that the prefill counted (``compat.stats``).

Not a test module: pytest collects ``test_*.py`` only.
"""
import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_lm_mesh_ranks as lm_ranks
import torch_train_mesh_ranks as train_ranks
from repro_torch import carry
from repro_torch.configs import registry
from repro_torch.data.pipeline import shard_batch
from repro_torch.distributed import compat, sharding
from repro_torch.models import model as M
from repro_torch.models import perfcfg
from repro_torch.train import optimizer as opt
from repro_torch.train.step import dp_summed

SHAPE = (2, 4)


def config(case):
    return dataclasses.replace(registry.get_smoke_config(case["arch"]),
                               **case["cfg"])


def _grads(params, specs, cfg, ctx, tokens):
    """The gradients of ``loss_fn`` summed over the dp axes, whole on
    rank 0 (None on the others)."""
    leaves = [p for _, p in opt.flatten(params)]
    for t in leaves:
        t.requires_grad_(True)
    batch = shard_batch({"tokens": tokens}, ctx)
    loss, _ = M.loss_fn(params, cfg, batch, ctx=ctx, rows=tokens.shape[0])
    g = torch.autograd.grad(loss, leaves, allow_unused=True,
                            materialize_grads=True)
    g = dp_summed(opt.unflatten(params, list(g)), ctx, specs, ctx.dp_axes)
    for t in leaves:
        t.requires_grad_(False)
    return train_ranks.whole(g, specs, ctx)


def job(inputs, cases):
    ctx = lm_ranks.ctx_of(SHAPE)
    first = all(ctx.coord(a) == 0 for a in ctx.shape)
    out = {}
    for case in cases:
        cfg = config(case)
        tree = lm_ranks.load_params(os.path.join(inputs,
                                                 case["weights"] + ".npz"))
        whole = carry.lm_params_from_reference(tree, cfg, "cpu")
        specs = sharding.build_param_specs(whole, cfg, ctx)
        params = carry.lm_params_from_reference(tree, cfg, "cpu", ctx=ctx)
        tokens = np.load(os.path.join(inputs, case["tokens"]))
        perfcfg.reset()
        perfcfg.set_flags(**case["flags"])
        tag = case["tag"]
        try:
            if case["prefill"]:
                compat.stats = {}
                with torch.no_grad():
                    logits, _, _ = M.apply_prefill(
                        params, cfg, {"tokens": torch.from_numpy(tokens)},
                        ctx=ctx)
                out[f"{tag}/stats"] = compat.stats
                compat.stats = None
                logits = lm_ranks._whole(logits, cfg, ctx, tokens.shape[0])
                if first:
                    out[f"{tag}/prefill"] = logits.numpy()
            if case["grads"]:
                grads = _grads(params, specs, cfg, ctx, tokens)
                if first:
                    out[f"{tag}/grads"] = grads
        finally:
            compat.stats = None
            perfcfg.reset()
    return out


def run(root, **kw):
    """``job(**kw)`` on the 8 ranks; every rank's result, by rank."""
    mp.spawn(_entry, args=(8, str(root), kw), nprocs=8, join=True)
    out = []
    for rank in range(8):
        with open(os.path.join(root, f"{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank, world, root, kw):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "filestore"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=lm_ranks.TIMEOUT)
    try:
        out = job(**kw)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
