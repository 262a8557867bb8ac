"""The ranks of ``tests/test_torch_lm_mesh.py``: each runs in a process of
its own (``torch.multiprocessing.spawn``), joins a gloo group through a
``FileStore`` under the test's directory, imports torch and
``repro_torch`` only, serves the test's cases on the CPU and pickles
what it found to ``<dir>/<rank>.pkl``.

The weights of each case are the numpy arrays the test wrote in the
reference's (stacked) tree, ``<case>.npz`` keyed by path, bf16 as its
uint16 bits; a rank carries them in as its blocks
(``carry.lm_params_from_reference(..., ctx=)``).

Not a test module: pytest collects ``test_*.py`` only.
"""
import dataclasses
import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import carry
from repro_torch.configs import registry
from repro_torch.distributed import sharding
from repro_torch.distributed.meshctx import MeshCtx
from repro_torch.launch import serve as launcher
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.serve import step

TIMEOUT = datetime.timedelta(seconds=120)
NEW = 4                        # greedy tokens a case
MOE_ARCH = "qwen3-moe-235b-a22b"


def config(arch, dtype):
    return dataclasses.replace(registry.get_smoke_config(arch), dtype=dtype)


def save_params(path, flat):
    """``flat``: {path: numpy array}; bf16 (ml_dtypes) as uint16 bits."""
    out = {}
    for key, a in flat.items():
        if a.dtype.name == "bfloat16":
            out[key + "|bf16"] = a.view(np.uint16)
        else:
            out[key] = a
    np.savez(path, **out)


def load_params(path):
    """The reference's tree of torch tensors from ``save_params``' file."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            a = z[key]
            name, bf16 = (key[:-5], True) if key.endswith("|bf16") else \
                (key, False)
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
                if bf16 else torch.from_numpy(a)
            node = tree
            parts = name.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
    return tree


def run(world, job, root, **kw):
    """Run ``job`` on ``world`` gloo ranks; every rank's result, by rank."""
    mp.spawn(_entry, args=(world, str(root), job, kw), nprocs=world,
             join=True)
    out = []
    for rank in range(world):
        with open(os.path.join(root, f"{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank, world, root, job, kw):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "filestore"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        out = JOBS[job](**kw)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def ctx_of(shape):
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    return MeshCtx(mesh, dp_axes=("data",), device="cpu")


def _np(t):
    return t.float().numpy()


def job_serve(shape, cases, inputs):
    """Every case on a ``shape`` mesh: the rank's prefill logits block,
    and ``generate``'s greedy tokens and each step's whole logits; the
    first MoE block's input and output of the MoE case in f32; whether
    ``sharded_init``'s blocks are slices of ``M.init``'s leaves; the
    launcher's tokens on the mesh."""
    ctx = ctx_of(shape)
    prompt = np.load(os.path.join(inputs, "prompt.npy"))
    out = {"coord": (ctx.coord("data"), ctx.coord("model")), "cases": {}}
    for arch, dtype in cases:
        cfg = config(arch, dtype)
        tree = load_params(os.path.join(inputs, f"{arch}-{dtype}.npz"))
        params = carry.lm_params_from_reference(tree, cfg, "cpu", ctx=ctx)
        record = arch == MOE_ARCH and dtype == "float32"
        moe.moe_apply.record = [] if record else None
        try:
            logits, _, _ = M.apply_prefill(
                params, cfg, {"tokens": torch.from_numpy(prompt)}, ctx=ctx)
            first = moe.moe_apply.record[0] if record else None
        finally:
            moe.moe_apply.record = None
        steps = []
        toks = step.generate(params, cfg, prompt, max_new=NEW,
                             max_len=prompt.shape[1] + NEW, ctx=ctx,
                             logits=steps)
        out["cases"][arch, dtype] = {
            "prefill": _np(logits), "tokens": toks.numpy(),
            "steps": [_np(s) for s in steps]}
        if first is not None:
            out["moe_first"] = {k: _np(first[k]) for k in ("x", "y")}
            out["replayed"] = replayed(tree, cfg, ctx, prompt)
    cfg = config("qwen3-4b", "float32")
    blocks = sharding.sharded_init(cfg, ctx, seed=3)
    whole = M.init(cfg, seed=3, device="cpu")
    specs = sharding.build_param_specs(whole, cfg, ctx)
    same = []

    def walk(b, w, s):
        if isinstance(w, dict):
            for k in w:
                walk(b[k], w[k], s[k])
        elif isinstance(w, list):
            for x, y, z in zip(b, w, s):
                walk(x, y, z)
        else:
            ref = sharding.block(w, s, ctx)
            same.append(b.shape == ref.shape and b.dtype == ref.dtype
                        and torch.equal(b, ref) and b.is_contiguous())
    walk(blocks, whole, specs)
    out["sharded_init"] = (len(same), all(same))
    out["launcher"] = launcher.main([
        "--arch", "qwen3-4b", "--smoke", "--batch", "4", "--max-new", "3",
        "--mesh", f"{shape[0]},{shape[1]}", "--dist-backend", "gloo",
        "--device", "cpu"]).tokens.numpy()
    return out


def replayed(tree, cfg, ctx, prompt):
    """One device's prefill logits at a capacity factor where nothing
    drops, and the mesh's with one device's routing replayed (the
    rank's block): ``moe_apply.replay`` on the mesh."""
    cfg = dataclasses.replace(cfg, capacity_factor=100.0)
    batch = {"tokens": torch.from_numpy(prompt)}
    one = carry.lm_params_from_reference(tree, cfg, "cpu")
    moe.moe_apply.record = []
    try:
        want, _, _ = M.apply_prefill(one, cfg, batch)
        routing = [r["expert_id"] for r in moe.moe_apply.record]
    finally:
        moe.moe_apply.record = None
    params = carry.lm_params_from_reference(tree, cfg, "cpu", ctx=ctx)
    moe.moe_apply.replay = list(routing)
    try:
        got, _, _ = M.apply_prefill(params, cfg, batch, ctx=ctx)
        left = len(moe.moe_apply.replay)
    finally:
        moe.moe_apply.replay = None
    return {"one": _np(want), "mesh": _np(got), "left": left}


JOBS = {"serve": job_serve}
