"""The port's sharding rules (``repro_torch.distributed.sharding``) and
cache layout (``repro_torch.serve.step.cache_specs``) against the JAX
package's, rule for rule.

Both sides read only a ctx's axis sizes and roles, so neither needs a
mesh of devices: the reference's ``MeshCtx`` gets a mesh that has only
``.shape``, the port's one with only its axis names and a shape. The
param trees are the reference's ``jax.eval_shape`` of ``M.init`` at
full size, for all ten archs, laid out as the port lays them out
(``port_layout``: one dict a layer, the reference's layer axis
dropped); ``port_layout`` is held to the port's own ``M.init`` tree on
the smoke configs. Every comparison is exact.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.distributed import sharding as ref_sharding
from repro.distributed.meshctx import MeshCtx as RefCtx
from repro.models import model as RM
from repro.serve import step as ref_step
from repro.train import optimizer as ref_opt
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.meshctx import MeshCtx
from repro_torch.models import model as M
from repro_torch.serve import step
from repro_torch.train import optimizer as opt

torch.set_num_threads(2)
ARCHS = list(ref_registry.ARCH_NAMES)
MESHES = {"1x1": ((1, 1), ("data", "model"), ("data",)),
          "4x2": ((4, 2), ("data", "model"), ("data",)),
          "2x4": ((2, 4), ("data", "model"), ("data",)),
          "16x16": ((16, 16), ("data", "model"), ("data",)),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"),
                      ("pod", "data"))}
STACKED = {"blocks", "dense_blocks", "moe_blocks", "self_blocks",
           "cross_blocks", "mamba"}


def ctxs(mesh):
    shape, names, dp = MESHES[mesh]
    ref = RefCtx(mesh=types.SimpleNamespace(shape=dict(zip(names, shape))),
                 dp_axes=dp, fsdp_axis="data", tp_axis="model")
    port = MeshCtx(types.SimpleNamespace(mesh_dim_names=names,
                                         mesh=np.empty(shape)),
                   dp_axes=dp, fsdp_axis="data", tp_axis="model",
                   device="cpu")
    return ref, port


def ref_shapes(arch, smoke=False):
    cfg = (ref_registry.get_smoke_config if smoke
           else ref_registry.get_config)(arch)
    return cfg, jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), cfg))


def _shape(leaf, stacked):
    return tuple(leaf.shape[1:] if stacked else leaf.shape)


def port_layout(tree, cfg, fn=lambda leaf, stacked: leaf):
    """The reference's tree (of params, or of an optimizer's m or v) as
    the port lays it out, each leaf ``fn(leaf, stacked)`` once a layer:
    the transformers' ``dense_blocks`` and ``moe_blocks`` (or
    ``blocks``, or the VLM's ``self_blocks``) as ``blocks``, the VLM's
    ``cross_blocks``, rwkv6's ``blocks``, zamba2's ``mamba``; the rest as
    it is."""
    def conv(t, stacked):
        if isinstance(t, dict):
            return {k: conv(v, stacked) for k, v in t.items()}
        return fn(t, stacked)

    def n_of(t):
        while isinstance(t, dict):
            t = next(iter(t.values()))
        if isinstance(t, tuple):            # a (spec, leaf) pair
            t = t[1]
        t = getattr(t, "q", t)
        return t.shape[0]

    out = {}
    for key, sub in tree.items():
        if key in STACKED:
            name = {"dense_blocks": "blocks", "moe_blocks": "blocks",
                    "self_blocks": "blocks"}.get(key, key)
            out.setdefault(name, []).extend(
                conv(sub, True) for _ in range(n_of(sub)))
        else:
            out[key] = conv(sub, False)
    if "dense_blocks" in tree and "moe_blocks" in tree:
        assert len(out["blocks"]) == cfg.n_layers
    return out


def _pad(spec, n):
    spec = tuple(spec)
    return spec + (None,) * (n - len(spec))


def _ref_port_spec(spec, leaf, stacked):
    full = _pad(spec, len(leaf.shape))
    return full[1:] if stacked else full


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_port_layout_is_the_ports_own_tree(arch):
    """``port_layout`` of the reference's smoke tree has the paths and
    shapes of the port's ``M.init``."""
    cfg, shapes = ref_shapes(arch, smoke=True)
    want = port_layout(shapes, cfg, lambda leaf, st: _shape(leaf, st))
    got = M.init(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    assert {p: tuple(t.shape) for p, t in _flat(got)} == dict(_flat(want))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_references_without_the_layer_axis(arch, mesh):
    cfg, shapes = ref_shapes(arch)
    ref_ctx, ctx = ctxs(mesh)
    ref_specs = ref_sharding.build_param_specs(shapes, cfg, ref_ctx)
    want = port_layout(
        jax.tree.map(lambda s, leaf: (s, leaf), ref_specs, shapes,
                     is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)),
        cfg, lambda pair, st: _ref_port_spec(pair[0], pair[1], st))
    port_shapes = port_layout(shapes, cfg, lambda leaf, st: types.SimpleNamespace(
        shape=_shape(leaf, st)))
    got = sharding.build_param_specs(port_shapes,
                                     ModelConfig(**dataclasses.asdict(cfg)),
                                     ctx)
    assert dict(_flat(got)) == dict(_flat(want))


def test_the_rules_shard_what_the_docstring_says():
    """A few specs spelled out, on the production 16 x 16 mesh:
    qwen2's 14 heads replicate attention over ``model`` but shard its
    FFN and vocabulary; qwen3-moe's experts shard E over ``model`` and d
    over ``data``, and its router replicates."""
    _, ctx = ctxs("16x16")
    q2 = registry.get_config("qwen2-0.5b")
    spec = sharding.leaf_spec
    assert spec(("attn", "wq"), (896, 896), q2, ctx, True) == ("data", None)
    assert spec(("mlp", "w_up"), (896, 4864), q2, ctx, True) == (
        "data", "model")
    assert spec(("mlp", "w_down"), (4864, 896), q2, ctx, True) == (
        "model", "data")
    assert spec(("embed", "table"), (151_936, 896), q2, ctx) == (
        "model", "data")
    moe = registry.get_config("qwen3-moe-235b-a22b")
    assert spec(("moe", "w_gate"), (128, 4096, 1536), moe, ctx, True) == (
        "model", "data", None)
    assert spec(("moe", "w_down"), (128, 1536, 4096), moe, ctx, True) == (
        "model", None, "data")
    assert spec(("moe", "router"), (4096, 128), moe, ctx, True) == (
        None, None)


FAMILY_ARCHS = {"dense": "qwen3-4b", "moe": "qwen3-moe-235b-a22b",
                "ssm": "rwkv6-7b", "hybrid": "zamba2-1.2b",
                "vlm": "llama-3.2-vision-90b", "audio": "musicgen-medium"}


def _drop_superblock_axis(spec):
    """The reference's VLM self cache ``[n_sb, per, B, S, KV, hd]`` as
    the port's flat ``[n_layers, B, S, KV, hd]``: its ``per`` axis
    (never sharded) merges into the layer axis."""
    spec = _pad(spec, 6)
    assert spec[1] is None
    return (spec[0],) + spec[2:]


@pytest.mark.parametrize("batch", [1, 2, 8, 32, 48])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_cache_specs_are_the_references(family, mesh, batch):
    """Every family's cache tree, at batch sizes that divide ``dp_size``
    and that do not (then the sequence shards over ``fsdp``)."""
    arch = FAMILY_ARCHS[family]
    ref_cfg = ref_registry.get_config(arch)
    cfg = registry.get_config(arch)
    ref_ctx, ctx = ctxs(mesh)
    want = ref_step.cache_specs(ref_cfg, ref_ctx, batch)
    got = step.cache_specs(cfg, ctx, batch)

    def norm(tree, vlm_self=False):
        return {k: norm(v) if isinstance(v, dict) else
                (_drop_superblock_axis(v) if vlm_self and k in ("k", "v")
                 else tuple(v)) for k, v in tree.items()}
    assert norm(got) == norm(want, vlm_self=family == "vlm")


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mesh", ["4x2", "16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_are_the_references(arch, mesh, int8):
    cfg, shapes = ref_shapes(arch)
    ref_ctx, ctx = ctxs(mesh)
    ocfg = ref_base.OptimizerConfig(int8_states=int8)
    state = jax.eval_shape(lambda p: ref_opt.init_state(ocfg, p), shapes)
    ref_specs = ref_sharding.build_param_specs(shapes, cfg, ref_ctx)
    want = ref_sharding.opt_state_specs(state, ref_specs, ref_ctx)

    def as_port(leaf, st):
        ns = lambda a: types.SimpleNamespace(  # noqa: E731
            shape=_shape(a, st))
        if isinstance(leaf, ref_opt.QTensor):
            return opt.QTensor(q=ns(leaf.q), scale=ns(leaf.scale),
                               shape=_shape(leaf.q, st))
        return ns(leaf)

    port_cfg = ModelConfig(**dataclasses.asdict(cfg))
    port_state = {"step": (), "m": port_layout(
        state["m"], cfg, as_port), "v": port_layout(state["v"], cfg, as_port)}
    port_shapes = port_layout(shapes, cfg, lambda leaf, st: types.SimpleNamespace(
        shape=_shape(leaf, st)))
    got = sharding.opt_state_specs(
        port_state, sharding.build_param_specs(port_shapes, port_cfg, ctx),
        ctx)

    for part in ("m", "v"):
        flat_want = jax.tree_util.tree_flatten_with_path(
            state[part], is_leaf=lambda x: isinstance(x, ref_opt.QTensor))[0]
        spec_want = jax.tree_util.tree_leaves(
            want[part], is_leaf=lambda x: isinstance(
                x, (ref_opt.QTensor, jax.sharding.PartitionSpec)))
        want_port = port_layout(jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(
                state[part], is_leaf=lambda x: isinstance(x, ref_opt.QTensor)),
            list(zip(spec_want, (leaf for _, leaf in flat_want)))),
            cfg, lambda pair, st: _spec_pair(pair, st))
        assert dict(_flat(_specs_only(got[part]))) == dict(_flat(want_port))
    assert got["step"] == ()


def _spec_pair(pair, stacked):
    """A reference (spec, state leaf) as the port's spec: a QTensor's
    payload and scale specs, the layer axis dropped, or a moment's."""
    spec, leaf = pair
    if isinstance(leaf, ref_opt.QTensor):
        q = _ref_port_spec(spec.q, leaf.q, stacked)
        s = _ref_port_spec(spec.scale, leaf.scale, stacked)
        return ("qtensor", q, s)
    return _ref_port_spec(spec, leaf, stacked)


def _specs_only(tree):
    if isinstance(tree, dict):
        return {k: _specs_only(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_specs_only(v) for v in tree]
    if isinstance(tree, opt.QTensor):
        return ("qtensor", tree.q, tree.scale)
    return tree


def test_shard_params_cuts_blocks_that_tile_the_whole_leaf():
    """On every coordinate of a 2 x 2 mesh the blocks of a leaf are the
    spec's slices, and together they tile it once."""
    cfg = dataclasses.replace(registry.get_smoke_config("kimi-k2-1t-a32b"),
                              dtype="float32")
    params = M.init(cfg, device="cpu")
    specs = sharding.build_param_specs(params, cfg, ctxs("2x4")[1])
    seen = {p: torch.zeros(t.shape) for p, t in _flat(params)}
    for d in range(2):
        for m in range(4):
            ctx = _at(ctxs("2x4")[1], {"data": d, "model": m})
            blocks = dict(_flat(sharding.shard_params(params, cfg, ctx)))
            for path, leaf in _flat(params):
                spec = dict(_flat(specs))[path]
                want = sharding.block(leaf, spec, ctx)
                assert torch.equal(blocks[path], want)
                assert blocks[path].data_ptr() != leaf.data_ptr()
                sharding.block(seen[path], spec, ctx).add_(1.0)
    for path, count in seen.items():
        spec = dict(_flat(specs))[path]
        copies = 1
        for axis in ("data", "model"):
            if axis not in spec:
                copies *= {"data": 2, "model": 4}[axis]
        assert (count == copies).all(), path


def _at(ctx, coords):
    """``ctx`` seen from the rank at ``coords``."""
    class At(type(ctx)):
        def coord(self, axis):
            return coords[axis]
    return At(ctx.mesh, dp_axes=ctx.dp_axes, fsdp_axis=ctx.fsdp_axis,
              tp_axis=ctx.tp_axis, device="cpu")


@pytest.mark.parametrize("mesh", ["2x4", "2x16x16"])
def test_ctx_block_tiles_a_dimension_in_partition_spec_order(mesh):
    """``MeshCtx.block`` over one axis or several (the first major): the
    ranks' blocks tile the dimension once, in the order the reference's
    ``PartitionSpec`` lays them out, and ``axes_size`` counts them."""
    shape, names, _ = MESHES[mesh]
    ctx = ctxs(mesh)[1]
    for axes in (None, "model", names[:-1], (names[-1], names[-2])):
        size = ctx.axes_size(axes)
        n = 2 * size
        starts = set()
        for at in np.ndindex(*shape):
            c = dict(zip(names, at))
            blk = _at(ctx, c).block(n, axes)
            assert blk.stop - blk.start == n // size
            index = 0
            for axis in (() if axes is None else
                         (axes,) if isinstance(axes, str) else axes):
                index = index * ctx.shape[axis] + c[axis]
            assert blk.start == index * (n // size)
            starts.add(blk.start)
        assert len(starts) == size
    with pytest.raises(ValueError):
        _at(ctx, dict.fromkeys(names, 0)).block(
            ctx.axes_size("model") + 1, "model")
