"""The LM on a mesh, on the CPU: ranks of a gloo ``torch.distributed``
world, one process each (``tests/torch_lm_mesh_ranks.py``), against the
JAX package's LM on the same mesh shape.

Two worlds of 8 ranks run once each, as module fixtures whose results
the tests read: a 4 x 2 and a 2 x 4 ``("data", "model")`` mesh. The
reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on an Auto-axis
``jax.sharding.Mesh`` (ROADMAP C25: its prefill raises under
``jax.make_mesh``'s Explicit axes), started before the worlds so that
the two run side by side. Both take the same numpy weights (the
reference's tree, drawn here with numpy from a seed) and prompts: the
smoke configs of qwen3-4b, qwen2-0.5b (QKV bias), gemma3-4b (sliding
window), qwen3-moe-235b-a22b and kimi-k2-1t-a32b (a dense lead and a
shared expert), each at the config's capacity factor 1.25, in f32 and
bf16. The smoke configs' 2 kv heads do not divide the 2 x 4 mesh's
model axis of 4, so there the cache's sequence shards over ``model``
and a rank's one q head meets a kv head it takes from the replicated k
and v.

Tolerances, each with its reason:

  - f32, 1e-5 (rtol and atol): the same products summed in other orders
    (the row-parallel sums over ``model``, attention tiles, flash-
    decoding's combine); the reference's own mesh moves its logits
    2.3e-6 at most from one device.
  - bf16, ``lm_atol``: 0.1, or six bf16 ulps at the largest logit where
    that is more (``chip_smoke.py``'s limit): every layer rounds to
    bf16, and the two packages round sums taken in other orders.
    Greedy tokens agree up to the first step where the reference's own
    top-2 margin is below that limit.
  - the MoE at capacity factor 1.25: the mesh's per-shard capacities
    drop other assignments than one device does (ROADMAP C26), so the
    port is held to the reference's mesh result within the limits
    above, and both are far from the reference's one-device result.
  - ``dispatch_simulated`` against the reference's 4 x 2 MoE block, f32:
    1e-5; each rank's first MoE block against ``dispatch_simulated`` on
    the gathered inputs: 1e-6 (the same arithmetic, one process).
"""
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_lm_mesh_ranks as ranks
from repro.configs import registry as ref_registry
from repro.models import model as RM
from repro_torch import carry
from repro_torch.distributed import sharding
from repro_torch.distributed.meshctx import MeshCtx
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.serve import step

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"4x2": (4, 2), "2x4": (2, 4)}
ARCHS = ["qwen3-4b", "qwen2-0.5b", "gemma3-4b", "qwen3-moe-235b-a22b",
         "kimi-k2-1t-a32b"]
DTYPES = ["float32", "bfloat16"]
CASES = [(a, d) for a in ARCHS for d in DTYPES]
B, S = 4, 8
F32_TOL = 1e-5
LM_ULPS = 6
MOE_ARCH = ranks.MOE_ARCH
OTHER_FAMILIES = ["rwkv6-7b", "zamba2-1.2b", "llama-3.2-vision-90b",
                  "musicgen-medium"]

REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
from jax.sharding import Mesh
from repro.configs import registry
from repro.distributed.meshctx import MeshCtx, single_device_ctx
from repro.distributed.sharding import build_param_shardings
from repro.models import model as RM
from repro.models import moe as RMoE

assert len(jax.devices()) == 8
root, NEW, part = sys.argv[1], int(sys.argv[2]), sys.argv[3]
cases = json.load(open(os.path.join(root, f"cases_{part}.json")))
prompt = jnp.asarray(np.load(os.path.join(root, "prompt.npy")))
B, S = prompt.shape
out = {}


def compiled(fn, dtype):
    # bf16 without XLA's excess precision, as tests/test_torch_lm.py runs
    # the reference: a fused bf16 chain rounds at each operation
    jitted = jax.jit(fn)
    if dtype != "bfloat16":
        return jitted
    cache = {}
    def run(*args):
        key = str(jax.tree.map(lambda a: (jnp.shape(a), jnp.result_type(a)),
                               args))
        if key not in cache:
            cache[key] = jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return cache[key](*args)
    return run


def load(arch, dtype, cfg):
    z = np.load(os.path.join(root, f"{arch}-{dtype}.npz"))
    shapes = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), cfg))
    def leaf(path, _):
        key = "/".join(p.key for p in path)
        if key + "|bf16" in z.files:
            return jnp.asarray(z[key + "|bf16"].view(ml_dtypes.bfloat16))
        return jnp.asarray(z[key])
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def auto_mesh(shape):
    return MeshCtx(mesh=Mesh(np.array(jax.devices()).reshape(shape),
                             ("data", "model")),
                   dp_axes=("data",), fsdp_axis="data", tp_axis="model")


for arch, dtype, meshes in cases:
    cfg = dataclasses.replace(registry.get_smoke_config(arch), dtype=dtype)
    params = load(arch, dtype, cfg)
    for mesh in meshes:
        if mesh == "1x1":
            ctx, p = single_device_ctx(), params
        else:
            ctx = auto_mesh(tuple(int(v) for v in mesh.split("x")))
            p = jax.device_put(params, build_param_shardings(params, cfg, ctx))
        prefill = compiled(lambda p, b: RM.apply_prefill(p, cfg, ctx, b),
                           dtype)
        decode = compiled(lambda p, b, c, i: RM.apply_decode(
            p, cfg, ctx, b, c, i), dtype)
        logits, _, kv = prefill(p, {"tokens": prompt})
        tag = f"{arch}/{dtype}/{mesh}"
        out[tag + "/prefill"] = np.asarray(logits, np.float32)
        cache = jax.tree.map(
            lambda dst, src: jax.lax.dynamic_update_slice(
                dst, src.astype(dst.dtype), (0,) * src.ndim),
            RM.init_cache(cfg, B, S + NEW), kv)
        step = logits[:, -1:]
        toks, steps = [], []
        for i in range(NEW):
            if i:
                step, _, cache = decode(p, {"tokens": toks[-1]}, cache,
                                        jnp.int32(S + i - 1))
            steps.append(np.asarray(step, np.float32))
            toks.append(jnp.argmax(step, axis=-1).astype(jnp.int32))
        out[tag + "/steps"] = np.stack(steps)
        out[tag + "/tokens"] = np.asarray(jnp.concatenate(toks, axis=1))

if part != "4x2":
    np.savez(os.path.join(root, f"out_{part}.npz"), **out)
    sys.exit(0)

# the MoE block alone on the 4 x 2 mesh (dispatch_simulated's twin)
z = np.load(os.path.join(root, "moe_block.npz"))
for arch in json.load(open(os.path.join(root, "moe_archs.json"))):
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype="float32")
    layer = {k.split("/", 1)[1]: z[k] for k in z.files
             if k.startswith(arch + "/") and k != arch + "/x"}
    p = {}
    for k, v in layer.items():
        node = p
        parts = k.split("/")
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = jnp.asarray(v)
    ctx = auto_mesh((4, 2))
    y, aux = jax.jit(lambda p, x: RMoE.moe_apply(p, x, cfg, ctx))(
        p, jnp.asarray(z[arch + "/x"]))
    out[f"block/{arch}/y"] = np.asarray(y)
    out[f"block/{arch}/aux"] = np.asarray(aux)

# ROADMAP C25: the prefill under jax.make_mesh's (Explicit) axes, the
# params laid out by the reference's rules as on the Auto mesh
cfg = dataclasses.replace(registry.get_smoke_config("qwen3-4b"),
                          dtype="float32")
params = load("qwen3-4b", "float32", cfg)
ctx = MeshCtx(mesh=jax.make_mesh((4, 2), ("data", "model")),
              dp_axes=("data",), fsdp_axis="data", tp_axis="model")
out["c25_axes"] = np.array(str(ctx.mesh.axis_types))
try:
    p = jax.device_put(params, build_param_shardings(params, cfg, ctx))
    jax.jit(lambda p, b: RM.apply_prefill(p, cfg, ctx, b))(
        p, {"tokens": prompt})
    out["c25"] = np.array("no error")
except Exception as e:
    out["c25"] = np.array(f"{type(e).__name__}: {e}"[:500])
np.savez(os.path.join(root, f"out_{part}.npz"), **out)
"""


def _np_params(arch, dtype, seed):
    """The reference's param tree for ``arch``'s smoke config, drawn with
    numpy: matrices N(0, 1/fan_in), the embedding N(0, 0.02²), norms
    1 + N(0, 0.1²), biases N(0, 0.1²); each leaf in its dtype there."""
    cfg = dataclasses.replace(ref_registry.get_smoke_config(arch),
                              dtype=dtype)
    shapes = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = "/".join(p.key for p in path)
        name = path[-1].key
        shape = leaf.shape
        if name in ("ln1", "ln2", "final_norm", "q_norm", "k_norm"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("bq", "bk", "bv"):
            a = 0.1 * rng.standard_normal(shape)
        elif name == "table":
            a = 0.02 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(shape[-2])
        flat[key] = a.astype(np.float32).astype(
            ml_dtypes.bfloat16 if leaf.dtype == jax.numpy.bfloat16
            else np.float32)
    return flat


def _moe_layer(arch, seed):
    """One MoE layer's whole params (numpy f32) and an input x [B, S, d]."""
    cfg = ref_registry.get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "w_gate": rng.standard_normal((E, d, ff)) / np.sqrt(d),
         "w_up": rng.standard_normal((E, d, ff)) / np.sqrt(d),
         "w_down": rng.standard_normal((E, ff, d)) / np.sqrt(ff)}
    if cfg.n_shared_experts:
        sh = cfg.n_shared_experts * ff
        p["shared/w_gate"] = rng.standard_normal((d, sh)) / np.sqrt(d)
        p["shared/w_up"] = rng.standard_normal((d, sh)) / np.sqrt(d)
        p["shared/w_down"] = rng.standard_normal((sh, d)) / np.sqrt(sh)
    x = rng.standard_normal((B, S, d))
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


def _tree(flat):
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = torch.from_numpy(v)
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    import json
    d = tmp_path_factory.mktemp("lm_mesh_in")
    prompt = np.random.default_rng(0).integers(0, 256, (B, S)).astype(
        np.int32)
    np.save(d / "prompt.npy", prompt)
    for i, (arch, dtype) in enumerate(CASES):
        ranks.save_params(d / f"{arch}-{dtype}.npz",
                          _np_params(arch, dtype, seed=10 + i))
    for part in SHAPES:             # one reference process a mesh shape
        cases = [[a, t, [part] + (["1x1"] if part == "4x2" and a == MOE_ARCH
                                  and t == "float32" else [])]
                 for a, t in CASES]
        (d / f"cases_{part}.json").write_text(json.dumps(cases))
    moe_archs = [MOE_ARCH, "kimi-k2-1t-a32b"]
    (d / "moe_archs.json").write_text(json.dumps(moe_archs))
    block = {}
    for j, arch in enumerate(moe_archs):
        p, x = _moe_layer(arch, seed=50 + j)
        block.update({f"{arch}/{k}": v for k, v in p.items()})
        block[f"{arch}/x"] = x
    np.savez(d / "moe_block.npz", **block)
    return d


@pytest.fixture(scope="module")
def reference_run(inputs):
    """The reference's subprocesses, one a mesh shape, started at once
    (they run beside the worlds); ``reference`` waits for them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(inputs), str(ranks.NEW),
         part], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for part in SHAPES]
    yield procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def worlds(inputs, reference_run, tmp_path_factory):
    return {name: ranks.run(8, "serve", tmp_path_factory.mktemp(name),
                            shape=shape, cases=CASES, inputs=str(inputs))
            for name, shape in SHAPES.items()}


@pytest.fixture(scope="module")
def reference(reference_run, inputs):
    out = {}
    for proc, part in zip(reference_run, SHAPES):
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        out.update(np.load(inputs / f"out_{part}.npz"))
    return out


def lm_atol(dtype, logits, ulps=LM_ULPS):
    """``chip_smoke.py``'s limit: f32 1e-5 here; bf16 0.1, or ``ulps``
    bf16 ulps (2^-7 relative) at the largest |logit| where that is
    more."""
    if dtype == "float32":
        return F32_TOL
    big = float(np.abs(logits).max())
    return max(0.1, ulps * 2.0 ** (np.floor(np.log2(max(big, 1e-30))) - 7))


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol if tol == F32_TOL else 0,
                               atol=tol)


def _rank_blocks(shape, coord, V=256):
    """The rank's (batch, vocabulary) blocks of the whole logits."""
    dp, m = shape
    r_dp, r_m = coord
    return (slice(r_dp * B // dp, (r_dp + 1) * B // dp),
            slice(r_m * V // m, (r_m + 1) * V // m))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(SHAPES))
def test_every_rank_serves_the_references_mesh_result(worlds, reference,
                                                       mesh, arch, dtype):
    """Prefill logits (each rank's block), each greedy step's logits and
    the 4 greedy tokens equal the reference's on the same mesh."""
    tag = f"{arch}/{dtype}/{mesh}"
    want_pre = reference[tag + "/prefill"]
    want_steps = reference[tag + "/steps"]
    want_toks = reference[tag + "/tokens"]
    for o in worlds[mesh]:
        got = o["cases"][arch, dtype]
        b, v = _rank_blocks(SHAPES[mesh], o["coord"])
        _close(got["prefill"], want_pre[b, :, v], lm_atol(dtype, want_pre))
        if dtype == "float32":
            np.testing.assert_array_equal(got["tokens"], want_toks)
        else:
            diff = np.argwhere(got["tokens"] != want_toks)
            first = min(diff[:, 1]) if diff.size else ranks.NEW
            for t in range(first):
                _close(got["steps"][t], want_steps[t],
                       lm_atol(dtype, want_steps[t]))
            if diff.size:       # they part only below the limit
                top2 = np.sort(want_steps[first][:, 0], axis=-1)[:, -2:]
                rows = diff[diff[:, 1] == first, 0]
                margin = top2[rows, 1] - top2[rows, 0]
                assert (margin < lm_atol(dtype, want_steps[first])).all()
            continue
        for t in range(ranks.NEW):
            _close(got["steps"][t], want_steps[t], F32_TOL)


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_moe_drops_per_shard_as_the_references_mesh_not_one_device(
        worlds, reference, mesh):
    """ROADMAP C26: at capacity factor 1.25 the MoE's capacities are per
    shard, so the reference's mesh result differs from its one-device
    one by far more than rounding, and the port gives the mesh's."""
    tag = f"{MOE_ARCH}/float32"
    mesh_logits = reference[f"{tag}/{mesh}/prefill"]
    one = reference[f"{tag}/1x1/prefill"]
    assert np.abs(mesh_logits - one).max() > 0.1
    whole = np.zeros_like(mesh_logits)
    for o in worlds[mesh]:
        b, v = _rank_blocks(SHAPES[mesh], o["coord"])
        got = o["cases"][MOE_ARCH, "float32"]["prefill"]
        _close(got, mesh_logits[b, :, v], F32_TOL)
        whole[b, :, v] = got
    assert np.abs(whole - one).max() > 0.1


@pytest.mark.parametrize("arch", [MOE_ARCH, "kimi-k2-1t-a32b"])
def test_dispatch_simulated_is_the_references_4x2_block(inputs, reference,
                                                        arch):
    cfg = ranks.config(arch, "float32")
    z = np.load(inputs / "moe_block.npz")
    p = _tree({k.split("/", 1)[1]: z[k] for k in z.files
               if k.startswith(arch + "/") and k != arch + "/x"})
    y, aux = moe.dispatch_simulated(p, torch.from_numpy(z[arch + "/x"]), cfg,
                                    dp=4, M=2)
    _close(y.numpy(), reference[f"block/{arch}/y"], F32_TOL)
    _close(float(aux), float(reference[f"block/{arch}/aux"]), F32_TOL)


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_each_ranks_first_moe_block_is_dispatch_simulated(inputs, worlds,
                                                          mesh):
    """The ranks' first MoE inputs, gathered over the dp blocks, through
    ``dispatch_simulated``: each rank's output block (before the shared
    expert; qwen3-moe has none)."""
    dp, M_ = SHAPES[mesh]
    cfg = ranks.config(MOE_ARCH, "float32")
    tree = ranks.load_params(inputs / f"{MOE_ARCH}-float32.npz")
    layer = carry.lm_params_from_reference(tree, cfg, "cpu")["blocks"][0]
    outs = worlds[mesh]
    x = np.concatenate([o["moe_first"]["x"] for o in outs
                        if o["coord"][1] == 0])
    y, _ = moe.dispatch_simulated(layer["moe"], torch.from_numpy(x), cfg,
                                  dp=dp, M=M_)
    for o in outs:
        b, _ = _rank_blocks(SHAPES[mesh], o["coord"])
        np.testing.assert_array_equal(o["moe_first"]["x"], x[b])
        _close(o["moe_first"]["y"], y.numpy()[b], 1e-6)


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_replayed_routing_on_the_mesh_is_one_devices(worlds, mesh):
    """``moe_apply.replay`` on a mesh: one device's whole-batch routing,
    each rank taking its tokens' ids, at a capacity factor where nothing
    drops, gives one device's logits."""
    for o in worlds[mesh]:
        r = o["replayed"]
        assert r["left"] == 0
        b, v = _rank_blocks(SHAPES[mesh], o["coord"])
        _close(r["mesh"], r["one"][b, :, v], F32_TOL)


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_sharded_init_blocks_are_slices_of_init(worlds, mesh):
    for o in worlds[mesh]:
        n, all_same = o["sharded_init"]
        assert n > 10 and all_same


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_the_launcher_serves_on_the_mesh_as_on_one_device(worlds, mesh):
    from repro_torch.launch import serve as launcher
    want = launcher.main(["--arch", "qwen3-4b", "--smoke", "--batch", "4",
                          "--max-new", "3", "--device", "cpu"]).tokens
    for o in worlds[mesh]:
        np.testing.assert_array_equal(o["launcher"], want.numpy())


def test_c25_the_references_prefill_raises_on_explicit_axes(reference):
    """ROADMAP C25: ``jax.make_mesh`` gives Explicit axes under jax 0.9,
    and there the reference's prefill raises at the embedding gather;
    the tests build an Auto-axis ``Mesh``."""
    assert "Explicit" in str(reference["c25_axes"])
    msg = str(reference["c25"])
    assert msg.startswith("ShardingTypeError"), msg
    assert ".at[...].get(out_sharding=)" in msg


def _fake_ctx(shape=(2, 2)):
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=np.empty(shape))
    return MeshCtx(mesh, dp_axes=("data",), device="cpu")


@pytest.mark.parametrize("arch", OTHER_FAMILIES)
def test_other_families_on_a_mesh_raise_naming_a8_5(arch):
    cfg = ranks.config(arch, "float32")
    ctx = _fake_ctx()
    for call in (lambda: sharding.sharded_init(cfg, ctx),
                 lambda: M.apply_prefill({}, cfg, {}, ctx=ctx),
                 lambda: M.apply_decode({}, cfg, {}, {}, 0, ctx=ctx),
                 lambda: step.generate({}, cfg, [[1, 2]], max_new=1,
                                       max_len=2, ctx=ctx),
                 lambda: carry.lm_params_from_reference({}, cfg, ctx=ctx)):
        with pytest.raises(NotImplementedError, match="A8.5"):
            call()
