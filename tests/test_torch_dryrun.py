"""The dry run (``repro_torch.launch.dryrun``) on smoke configs, over a
4 x 2 ``("data", "model")`` and a compressed 2 x 2 x 2 ``("pod",
"data", "model")`` dry mesh (``meshctx.dry_ctx``):

  - a rank's param, optimizer-state, error-feedback and cache bytes
    equal the sums of the reference's ``NamedSharding(...).shard_shape``
    over its ``build_param_specs``, ``opt_state_specs`` and
    ``cache_specs`` on an ``AbstractMesh`` of the same shape (the
    reference's own dry run is never imported here: it sets
    ``XLA_FLAGS`` to 512 devices when imported);
  - the collectives a rank counts on the meta device (calls and bytes,
    by op and axis, forward and backward) equal, exactly, what the same
    rank counts running the same step on real tensors in a gloo world
    of 8 (``tests/torch_dryrun_ranks.py``), for rank 0 and the last rank
    along ``model``; its FLOPs outside B4 equal ``FlopCounterMode``'s
    over that real step, and B4's equal ``attention_flops`` of the
    calls the real step made;
  - the dry run opens no process group and launches nothing.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

import torch_dryrun_ranks as ranks
from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.distributed import sharding as ref_sharding
from repro.distributed.meshctx import MeshCtx as RefCtx
from repro.models import model as RM
from repro.serve import step as ref_step
from repro.train import optimizer as ref_opt
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed.meshctx import dry_ctx
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun
from repro_torch.models import perfcfg

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
TRAIN = ShapeSpec("t", "train", 32, 8)
DECODE = ShapeSpec("d", "decode", 64, 8)
SPEC_ARCHS = ["qwen3-4b", "qwen2-0.5b", "qwen3-moe-235b-a22b", "rwkv6-7b",
              "zamba2-1.2b", "musicgen-medium", "llama-3.2-vision-90b"]


def _shard_bytes(mesh, structs, specs):
    """The sum over the leaves of one rank's block's bytes:
    ``NamedSharding(mesh, spec).shard_shape``."""
    leaves = jax.tree.leaves(structs)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return sum(math.prod(NamedSharding(mesh, s).shard_shape(l.shape))
               * l.dtype.itemsize for l, s in zip(leaves, spec_leaves))


def _reference_bytes(arch, mesh_name, int8, compress):
    shape, names = MESHES[mesh_name]
    mesh = AbstractMesh(shape, names)
    ctx = RefCtx(mesh=mesh, dp_axes=names[:-1], fsdp_axis="data",
                 tp_axis="model")
    cfg = ref_registry.get_smoke_config(arch)
    params = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), cfg))
    pspecs = ref_sharding.build_param_specs(params, cfg, ctx)
    opt_cfg = ref_base.OptimizerConfig(int8_states=int8,
                                       grad_compression=compress)
    state = jax.eval_shape(lambda p: ref_opt.init_state(opt_cfg, p), params)
    ospecs = ref_sharding.opt_state_specs(state, pspecs, ctx)
    cache = jax.eval_shape(lambda: RM.init_cache(cfg, DECODE.global_batch,
                                                 DECODE.seq_len))
    cspecs = ref_step.cache_specs(cfg, ctx, DECODE.global_batch)
    err = 0
    if compress and "pod" in names:
        err = _shard_bytes(mesh, jax.tree.map(
            lambda l: jax.ShapeDtypeStruct(l.shape, np.float32), params),
            pspecs)
    return {"params": _shard_bytes(mesh, params, pspecs),
            "opt_states": _shard_bytes(mesh, state, ospecs),
            "err": err, "cache": _shard_bytes(mesh, cache, cspecs)}


@pytest.mark.parametrize("mesh_name,int8,compress", [
    ("4x2", False, False), ("2x2x2", True, True)])
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_a_ranks_bytes_are_the_references_shard_shapes(arch, mesh_name, int8,
                                                       compress):
    shape, names = MESHES[mesh_name]
    cfg = registry.get_smoke_config(arch)
    ctx = dry_ctx(shape, names, (0,) * len(names))
    train, _ = dryrun.prepare(cfg, TRAIN, ctx, int8, compress)
    decode, _ = dryrun.prepare(cfg, DECODE, ctx)
    got = {k: dryrun._bytes(train[k]) for k in ("params", "opt_states",
                                                "err")}
    got["cache"] = dryrun._bytes(decode["cache"])
    assert all(t.device.type == "meta" for ts in train.values() for t in ts)
    assert got == _reference_bytes(arch, mesh_name, int8, compress)


# the real steps beside the dry ones: (tag, arch, kind, seq, batch, mesh,
# int8 states, compressed)
REAL = [("dense-train", "qwen3-4b", "train", 32, 8, "4x2", False, False),
        ("qwen2-train", "qwen2-0.5b", "train", 32, 8, "4x2", False, False),
        ("moe-prefill", "qwen3-moe-235b-a22b", "prefill", 16, 8, "4x2",
         False, False),
        ("rwkv-decode", "rwkv6-7b", "decode", 64, 8, "4x2", False, False),
        ("dense-compressed", "qwen3-4b", "train", 32, 8, "2x2x2", True,
         True)]


def _case(tag, arch, kind, seq, batch, mesh, int8, compress):
    shape, names = MESHES[mesh]
    return {"tag": tag, "arch": arch, "kind": kind, "seq": seq,
            "batch": batch, "mesh": list(shape), "names": list(names),
            "int8": int8, "compress": compress}


CASES = [_case(*c) for c in REAL]


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    return ranks.run(tmp_path_factory.mktemp("dryrun_world"), CASES)


def _counts(stats):
    """A stats dict without its seconds."""
    return {"by": stats.get("by", {}),
            **{k: v for k, v in stats.items()
               if k.endswith(("calls", "bytes"))}}


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["tag"] for c in CASES])
def test_the_dry_ranks_collectives_and_flops_are_the_real_steps(real, i):
    case = CASES[i]
    cfg, shape = ranks.case_of(case)
    names, mesh = tuple(case["names"]), tuple(case["mesh"])
    launches = fa.flash_attention_gqa.launches
    for got in (o[i] for o in real):
        coords = tuple(got["coords"][a] for a in names)
        if any(coords[:-1]) or coords[-1] not in (0, mesh[-1] - 1):
            continue    # rank 0 and the last rank along model
        dry = dryrun.dry_rank(cfg, shape, mesh, names, coords,
                              case["int8"], case["compress"])
        assert _counts(dry["collectives"]) == _counts(got["stats"]), coords
        assert dry["flops_b4"] == got["flops_b4"], coords
        assert dry["flops"] - dry["flops_b4"] == got["flops"], coords
    assert fa.flash_attention_gqa.launches == launches
    assert not dist.is_initialized()


def test_a_cell_records_the_larger_rank_and_what_fits():
    """``cell`` over a 1 x 4 dry mesh: rank 0 and the last rank along
    ``model`` both run and the record is the larger's. With
    ``seq_shard_attn`` (qwen2's smoke config with 6 q heads, which do not
    divide 4) the last rank's rows meet the most keys: its B4 FLOPs are
    ``attention_flops`` of its rows a layer."""
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              n_heads=6)
    perfcfg.set_variant("seqattn")
    try:
        rec = dryrun.cell(cfg, ShapeSpec("p", "prefill", 1024, 4),
                          ((1, 4), ("data", "model")))
    finally:
        perfcfg.reset()
    first, last = rec["ranks"]
    assert last["flops_b4"] > first["flops_b4"]
    assert rec["flops"] == max(first["flops"], last["flops"])
    assert last["flops_b4"] == cfg.n_layers * fa.attention_flops(
        4, 256, 1024, 6, cfg.head_dim, q_offset=768)
    assert rec["fits"] and rec["card_bytes"] == dryrun.card_bytes()
