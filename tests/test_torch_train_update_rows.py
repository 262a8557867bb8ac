"""AdamW's update a run of rows at a time against the whole leaf at once:
``optimizer.apply_updates`` takes a leaf of more than
``UPDATE_ROWS_ENTRIES`` entries in runs of its first dim, so that the
VLM's 1.05 B-entry embedding table fits the card beside its params,
gradients and states. Every entry's arithmetic is elementwise but for
the int8 blocks' absmax along the last axis, so the runs must leave the
params and states bit for bit those of one pass: f32 and int8 states on
one device, and int8 on a mesh of two gloo ranks where one quantization
block spans both ranks' halves of the last dim (its absmax a pmax over
``model``, taken once a run on each rank).
"""
import dataclasses
import datetime
import os
import pickle

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs.base import OptimizerConfig
from repro_torch.distributed.meshctx import MeshCtx
from repro_torch.train import optimizer as opt

CFG = OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10)
STEPS = 3


def _trained(shape, int8, rows_entries, ctx=None, specs=None, seed=0):
    """``STEPS`` AdamW steps of a leaf ``w`` of ``shape`` (a rank's block
    on a mesh) on seeded gradients, with updates ``rows_entries`` at a
    time: the params and states as plain tensors."""
    cfg = dataclasses.replace(CFG, int8_states=int8)
    was, opt.UPDATE_ROWS_ENTRIES = opt.UPDATE_ROWS_ENTRIES, rows_entries
    try:
        gen = torch.Generator().manual_seed(seed)
        params = {"w": torch.randn(shape, generator=gen)}
        state = opt.init_state(cfg, params, ctx, specs)
        for _ in range(STEPS):
            grads = {"w": torch.randn(shape, generator=gen)}
            opt.apply_updates(cfg, params, grads, state, ctx, specs)
    finally:
        opt.UPDATE_ROWS_ENTRIES = was
    out = {"w": params["w"]}
    for key in ("m", "v"):
        s = state[key]["w"]
        out.update({f"{key}/q": s.q, f"{key}/scale": s.scale} if int8
                   else {key: s})
    return out


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("shape,rows_entries", [
    ((300, 256), 1000),          # runs of 3 rows, the last of 300 % 3
    ((7, 40, 128), 5120),        # runs of one [40, 128] slab
    ((9, 384), 384 * 4),         # runs of 4 rows, the last one short
])
def test_runs_of_rows_update_as_the_whole_leaf(shape, rows_entries, int8):
    whole = _trained(shape, int8, 1 << 40)
    runs = _trained(shape, int8, rows_entries)
    assert set(whole) == set(runs)
    for key in whole:
        assert torch.equal(whole[key], runs[key]), key


def _rank(rank, root):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"), 2),
        rank=rank, world_size=2, timeout=datetime.timedelta(seconds=60))
    try:
        ctx = MeshCtx(init_device_mesh("cpu", (1, 2),
                                       mesh_dim_names=("data", "model")),
                      device="cpu")
        specs = {"w": (None, "model")}
        # the whole leaf [6, 192]: one block of 192 spans both ranks' 96
        out = {rows: _trained((6, 96), True, rows, ctx, specs, seed=rank)
               for rows in (1 << 40, 96)}
        out["own_scales"] = opt.blocked((6, 96), specs["w"], ctx).own_scales
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def test_runs_of_rows_update_as_the_whole_leaf_on_a_mesh(tmp_path):
    mp.start_processes(_rank, args=(str(tmp_path),), nprocs=2,
                       start_method="spawn")
    for rank in range(2):
        with open(tmp_path / f"{rank}.pkl", "rb") as f:
            out = pickle.load(f)
        assert out["own_scales"] is False
        whole, runs = out[1 << 40], out[96]
        for key in whole:
            assert torch.equal(whole[key], runs[key]), (rank, key)
        # the spanning block's scales are the pmax's: equal on both ranks
        if rank == 0:
            scales = whole["v/scale"]
        else:
            assert torch.equal(scales, whole["v/scale"])
