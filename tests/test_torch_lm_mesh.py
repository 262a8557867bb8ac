"""The LM on a mesh, on the CPU: ranks of a gloo ``torch.distributed``
world, one process each (``tests/torch_lm_mesh_ranks.py``), against the
JAX package's LM on the same mesh shape and on one device.

Two worlds of 8 ranks run once each, as module fixtures whose results
the tests read: a 4 x 2 and a 2 x 4 ``("data", "model")`` mesh. The
reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on an Auto-axis
``jax.sharding.Mesh`` (ROADMAP C25: its prefill raises under
``jax.make_mesh``'s Explicit axes), started before the worlds so that
the two run side by side. Both take the same numpy weights (the
reference's tree, drawn here with numpy from a seed) and prompts: the
smoke configs of every family, in f32 and bf16: qwen3-4b, qwen2-0.5b
(QKV bias), gemma3-4b (sliding window), qwen3-moe-235b-a22b and
kimi-k2-1t-a32b (a dense lead and a shared expert), each MoE at the
config's capacity factor 1.25; rwkv6-7b (the WKV state's heads over
``model``), zamba2-1.2b (the SSD state's heads over ``model``, the
shared block's B4 on the rank's heads), musicgen-medium on seeded frame
embeddings (``make_prefill`` and ``make_decode_step``; the reference
calls ``RM.apply_prefill`` and ``apply_decode``) and
llama-3.2-vision-90b on seeded f32 image embeddings (the bf16 model
upcasts, ROADMAP C7/C8; the reference calls ``RM.apply_prefill`` and
``apply_decode``, since its ``generate`` cannot, C21). The smoke
configs' 2 kv heads do not divide the 2 x 4 mesh's model axis of 4, so
there the cache's sequence shards over ``model`` (the VLM's image cache
too) and a rank's one q head meets a kv head it takes from the
replicated k and v. The four archs of ``ONE_DEVICE_ARCHS`` are also
held to the reference's one-device result, and their decode caches,
cut by ``serve.step.cache_specs``, to the reference's.

Tolerances, each with its reason:

  - f32, 1e-5 (rtol and atol): the same products summed in other orders
    (the row-parallel sums over ``model``, attention tiles, flash-
    decoding's combine; the reference's own mesh splits the SSD's
    N-contraction and the gated norm's sum of squares over ``model``,
    where the port gathers y); the reference's own mesh moves the
    transformers' logits 3.6e-6 at most from one device. The recurrent
    archs (``RECURRENT``) take ``tests/test_torch_recurrent.py``'s rule,
    1e-5 · max(1, max |reference|): their scans sum in f32 in other
    orders than XLA's, and the reference's own 2 x 4 mesh moves rwkv6's
    logits 1.6e-5 from its one device.
  - bf16, ``lm_atol``: 0.1, or six bf16 ulps at the largest logit where
    that is more (``chip_smoke.py``'s limit): every layer rounds to
    bf16, and the two packages round sums taken in other orders.
    rwkv6's 2 layers keep that limit: its scan sums in f32 and only
    the projections round. zamba2 and the VLM take 12 ulps
    (``chip_smoke.py``'s ``ZAMBA_ULPS``): the reference's own 2 x 4
    mesh moves their logits 6 and 9.75 ulps from its one device (the
    SSD state and its gated norm carry each rounded input through every
    later position; the VLM's cross layers add the f32 image k and v of
    N(0, 1) embeddings to a bf16 stream). Greedy tokens agree up to
    the first step where the reference's own top-2 margin is below that
    limit.
  - decode caches: as the logits in f32; in bf16 as many bf16 ulps, at
    the leaf's largest |value|, as the arch's logits take: its entries
    are bf16 roundings (the WKV and SSD states f32 sums of them) of sums
    taken in other orders, while a block cut from the wrong rows,
    heads or positions moves an entry by the leaf's own scale.
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
ONE_DEVICE_ARCHS = ["rwkv6-7b", "zamba2-1.2b", "musicgen-medium",
                    "llama-3.2-vision-90b"]
ARCHS = ["qwen3-4b", "qwen2-0.5b", "gemma3-4b", "qwen3-moe-235b-a22b",
         "kimi-k2-1t-a32b"] + ONE_DEVICE_ARCHS
DTYPES = ["float32", "bfloat16"]
CASES = [(a, d) for a in ARCHS for d in DTYPES]
B, S = 4, 8
F32_TOL = 1e-5
LM_ULPS = 6
ULPS = {"zamba2-1.2b": 12, "llama-3.2-vision-90b": 12}  # ZAMBA_ULPS
RECURRENT = ("rwkv6-7b", "zamba2-1.2b")
MOE_ARCH = ranks.MOE_ARCH

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
frames = jnp.asarray(np.load(os.path.join(root, "frames.npy")))
image = jnp.asarray(np.load(os.path.join(root, "image.npy")))
B, S = prompt.shape
out = {}


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


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


one_device = json.load(open(os.path.join(root, "one_device.json")))
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
        batch = {"tokens": prompt}
        if cfg.family == "audio":
            batch = {"embeds": frames[:, :S]}
        if cfg.family == "vlm":
            batch["image_embeds"] = image
        logits, _, kv = prefill(p, batch)
        tag = f"{arch}/{dtype}/{mesh}"
        out[tag + "/prefill"] = np.asarray(logits, np.float32)
        # the prefill's kv grown into a cache of S + NEW positions; the
        # VLM's image k and v as they are (f32 from f32 embeddings)
        cache = jax.tree.map(
            lambda dst, src: jax.lax.dynamic_update_slice(
                dst, src.astype(dst.dtype), (0,) * src.ndim),
            RM.init_cache(cfg, B, S + NEW), kv)
        for name in ("img_k", "img_v"):
            if name in kv:
                cache[name] = kv[name]
        if mesh != "1x1" and arch in one_device:
            for name, leaf in flat(cache).items():
                out[f"{tag}/cache/{name}"] = np.asarray(leaf, np.float32)
        step = logits[:, -1:]
        toks, steps = [], []
        for i in range(NEW):
            if i:
                b = {"embeds": frames[:, S + i - 1:S + i]} \
                    if cfg.family == "audio" else {"tokens": toks[-1]}
                step, _, cache = decode(p, b, cache, jnp.int32(S + i - 1))
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
    numpy: matrices N(0, 1/fan_in) (rwkv6's decay LoRA a tenth of
    that), the embedding N(0, 0.02²), norms and Mamba's D 1 + N(0, 0.1²),
    biases, rwkv6's bonus and Mamba's A_log and dt_bias N(0, 0.1²),
    rwkv6's lerp coefficients U(0, 1) and decay base -2 + N(0, 0.5²);
    each leaf in its dtype there."""
    cfg = dataclasses.replace(ref_registry.get_smoke_config(arch),
                              dtype=dtype)
    shapes = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = "/".join(p.key for p in path)
        name = path[-1].key
        shape = leaf.shape
        if name in ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "ln_x",
                    "norm", "gate_norm", "D"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("bq", "bk", "bv", "u", "A_log", "dt_bias"):
            a = 0.1 * rng.standard_normal(shape)
        elif name.startswith("mu_"):
            a = rng.uniform(0.0, 1.0, shape)
        elif name == "w0":
            a = -2.0 + 0.5 * rng.standard_normal(shape)
        elif name == "table":
            a = 0.02 * rng.standard_normal(shape)
        elif name in ("wA", "wB"):
            a = 0.1 * rng.standard_normal(shape) / np.sqrt(shape[-2])
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
    rng = np.random.default_rng(1)
    # musicgen's frame embeddings (prefill on S, one a decode step) and
    # the VLM's image embeddings, f32, N(0, 1): both smoke d_models are 64
    np.save(d / "frames.npy", rng.standard_normal(
        (B, S + ranks.NEW, 64)).astype(np.float32))
    np.save(d / "image.npy", rng.standard_normal((B, 16, 64)).astype(
        np.float32))
    for i, (arch, dtype) in enumerate(CASES):
        ranks.save_params(d / f"{arch}-{dtype}.npz",
                          _np_params(arch, dtype, seed=10 + i))
    for part in SHAPES:             # one reference process a mesh shape
        cases = [[a, t, [part] + (["1x1"] if part == "4x2" and (
            a in ONE_DEVICE_ARCHS or a == MOE_ARCH and t == "float32")
            else [])] for a, t in CASES]
        (d / f"cases_{part}.json").write_text(json.dumps(cases))
    (d / "one_device.json").write_text(json.dumps(ONE_DEVICE_ARCHS))
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


def _limit(arch, dtype, want):
    """(rtol, atol) of ``arch``'s results against the reference's
    ``want`` (see the module's docstring)."""
    if dtype == "float32":
        tol = F32_TOL * (max(1.0, float(np.abs(want).max()))
                         if arch in RECURRENT else 1.0)
        return tol, tol
    return 0.0, lm_atol(dtype, want, ULPS.get(arch, LM_ULPS))


def _rank_blocks(shape, coord, V=256):
    """The rank's (batch, vocabulary) blocks of the whole logits."""
    dp, m = shape
    r_dp, r_m = coord
    return (slice(r_dp * B // dp, (r_dp + 1) * B // dp),
            slice(r_m * V // m, (r_m + 1) * V // m))


def _held(worlds, reference, mesh, arch, dtype, against):
    """Each rank's prefill logits block, each greedy step's logits and
    the NEW greedy tokens against the reference's run ``against`` (the
    mesh's tag, or "1x1"), within ``_limit``: tokens equal in f32; in
    bf16 the steps' logits up to the first step where a token differs,
    and there only at a top-2 margin of the reference's below the
    limit."""
    tag = f"{arch}/{dtype}/{against}"
    want_pre = reference[tag + "/prefill"]
    want_steps = reference[tag + "/steps"]
    want_toks = reference[tag + "/tokens"]
    V = ranks.config(arch, dtype).vocab_size

    def close(got, want):
        rtol, atol = _limit(arch, dtype, want)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    for o in worlds[mesh]:
        got = o["cases"][arch, dtype]
        b, v = _rank_blocks(SHAPES[mesh], o["coord"], V)
        rtol, atol = _limit(arch, dtype, want_pre)
        np.testing.assert_allclose(got["prefill"], want_pre[b, :, v],
                                   rtol=rtol, atol=atol)
        if dtype == "float32":
            np.testing.assert_array_equal(got["tokens"], want_toks)
            for t in range(ranks.NEW):
                close(got["steps"][t], want_steps[t])
            continue
        diff = np.argwhere(got["tokens"] != want_toks)
        first = min(diff[:, 1]) if diff.size else ranks.NEW
        for t in range(first):
            close(got["steps"][t], want_steps[t])
        if diff.size:           # they part only below the limit
            top2 = np.sort(want_steps[first][:, 0], axis=-1)[:, -2:]
            rows = diff[diff[:, 1] == first, 0]
            margin = top2[rows, 1] - top2[rows, 0]
            assert (margin < _limit(arch, dtype, want_steps[first])[1]).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(SHAPES))
def test_every_rank_serves_the_references_mesh_result(worlds, reference,
                                                       mesh, arch, dtype):
    """Prefill logits (each rank's block), each greedy step's logits and
    the 4 greedy tokens equal the reference's on the same mesh."""
    _held(worlds, reference, mesh, arch, dtype, mesh)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ONE_DEVICE_ARCHS)
@pytest.mark.parametrize("mesh", list(SHAPES))
def test_every_rank_serves_the_references_one_device_result(
        worlds, reference, mesh, arch, dtype):
    """For these families the mesh changes nothing but the order of
    sums: each rank's results equal the reference's on one device."""
    _held(worlds, reference, mesh, arch, dtype, "1x1")


def _rank_ctx(shape, coord):
    """A ctx that answers as the rank at ``coord`` of a ``shape`` mesh
    does, for ``cache_specs`` and ``sharding.block``."""
    mesh = types.SimpleNamespace(
        mesh_dim_names=("data", "model"), mesh=np.empty(shape),
        get_local_rank=lambda axis: coord[("data", "model").index(axis)])
    return MeshCtx(mesh, dp_axes=("data",), device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ONE_DEVICE_ARCHS)
@pytest.mark.parametrize("mesh", list(SHAPES))
def test_decode_cache_blocks_are_the_references_cut_by_cache_specs(
        worlds, reference, mesh, arch, dtype):
    """After the prefill each rank's decode cache (``step.decode_cache``)
    is the reference's cache of S + NEW positions cut by
    ``cache_specs``: the WKV and SSD states with their heads over
    ``model``, the token-shift and conv states whole there, k and v by
    kv heads or (2 x 4) by sequence, the VLM's image cache over its
    sequence on 2 x 4."""
    cfg = ranks.config(arch, dtype)
    prefix = f"{arch}/{dtype}/{mesh}/cache/"
    want = {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}
    if cfg.family == "vlm":          # [n_sb, per, ...] -> one a self layer
        for name in ("k", "v"):
            want[name] = want[name].reshape(-1, *want[name].shape[2:])
    for o in worlds[mesh]:
        ctx = _rank_ctx(SHAPES[mesh], o["coord"])
        specs = ranks._flat(step.cache_specs(cfg, ctx, B))
        got = o["cases"][arch, dtype]["cache"]
        assert sorted(got) == sorted(want) == sorted(specs)
        for name, spec in specs.items():
            blk = sharding.block(torch.from_numpy(want[name]), spec,
                                 ctx).numpy()
            assert got[name].shape == blk.shape, name
            if dtype == "float32":
                _close(got[name], blk, F32_TOL)
            else:
                big = float(np.abs(want[name]).max())
                tol = ULPS.get(arch, LM_ULPS) * 2.0 ** (
                    np.floor(np.log2(max(big, 1e-30))) - 7)
                np.testing.assert_allclose(got[name], blk, rtol=0, atol=tol,
                                           err_msg=name)


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


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("mesh", list(SHAPES))
def test_recurrent_prefill_over_two_chunks_is_one_devices(worlds, mesh,
                                                          arch):
    """The cases above prefill 8 tokens, one chunk; over 128 tokens (two
    chunks of 64) the scans on a rank's heads carry their state from
    one chunk to the next: each rank's f32 logits block is the port's
    one-device prefill's (``tests/test_torch_recurrent.py`` holds that
    one to the reference over several chunks) within the recurrent f32
    limit."""
    for o in worlds[mesh]:
        got, whole = o["two_chunks"][arch]
        b, v = _rank_blocks(SHAPES[mesh], o["coord"])
        rtol, atol = _limit(arch, "float32", whole)
        np.testing.assert_allclose(got, whole[b, :, v], rtol=rtol, atol=atol)


@pytest.mark.parametrize("arch", list(ref_registry.ARCH_NAMES))
@pytest.mark.parametrize("mesh", list(SHAPES))
def test_sharded_init_blocks_are_slices_of_init(worlds, mesh, arch):
    """Every block ``sharding.sharded_init`` draws is the slice of
    ``M.init``'s leaf bit for bit, and a rank holds only its blocks:
    its parameter bytes are those of ``sharding.block``'s shapes."""
    for o in worlds[mesh]:
        n, all_same, bytes_held = o["sharded_init"][arch]
        assert n > 10 and all_same and bytes_held


@pytest.mark.parametrize("arch", ranks.LAUNCHER_ARCHS)
@pytest.mark.parametrize("mesh", list(SHAPES))
def test_the_launcher_serves_on_the_mesh_as_on_one_device(worlds, mesh,
                                                          arch):
    """``launch.serve.main --mesh`` gives one device's tokens (bf16, the
    smoke config's dtype): qwen3-4b's equal; the recurrent archs' equal
    up to the first step where one device's top-2 margin is below
    ``lm_atol`` (zamba2 at its 12 ulps), and part only there."""
    from repro_torch.launch import serve as launcher
    run = launcher.main(["--arch", arch, "--smoke", "--batch", "4",
                         "--max-new", "3", "--device", "cpu"])
    want = run.tokens.numpy()
    steps = []
    cfg = ranks.registry.get_smoke_config(arch)
    again = step.generate(run.params, cfg, run.prompt, max_new=3,
                          max_len=run.prompt.shape[1] + 3, device="cpu",
                          logits=steps)
    np.testing.assert_array_equal(again.numpy(), want)
    for o in worlds[mesh]:
        got = o["launcher"][arch]
        if arch not in RECURRENT:
            np.testing.assert_array_equal(got, want)
            continue
        diff = np.argwhere(got != want)
        if diff.size:
            first = min(diff[:, 1])
            logits = steps[first].float().numpy()
            top2 = np.sort(logits[:, 0], axis=-1)[:, -2:]
            rows = diff[diff[:, 1] == first, 0]
            limit = lm_atol("bfloat16", logits, ULPS.get(arch, LM_ULPS))
            assert (top2[rows, 1] - top2[rows, 0] < limit).all()


@pytest.mark.parametrize("arch, says", [
    ("musicgen-medium", "frame embeddings"),
    ("llama-3.2-vision-90b", "C21")])
def test_the_launcher_refuses_musicgen_and_the_vlm_on_a_mesh_first(
        arch, says):
    """``--mesh`` keeps the one-device launcher's refusals, before any
    work: no process group is started, no weight drawn."""
    import torch.distributed as dist
    from repro_torch.launch import serve as launcher
    from repro_torch.distributed import sharding as sh
    drawn = []
    real = sh.sharded_init
    sh.sharded_init = lambda *a, **k: drawn.append(a)
    try:
        with pytest.raises(SystemExit, match=says):
            launcher.main(["--arch", arch, "--smoke", "--mesh", "2,2",
                           "--dist-backend", "gloo", "--device", "cpu"])
    finally:
        sh.sharded_init = real
    assert not dist.is_initialized() and not drawn


def test_c25_the_references_prefill_raises_on_explicit_axes(reference):
    """ROADMAP C25: ``jax.make_mesh`` gives Explicit axes under jax 0.9,
    and there the reference's prefill raises at the embedding gather;
    the tests build an Auto-axis ``Mesh``."""
    assert "Explicit" in str(reference["c25_axes"])
    msg = str(reference["c25"])
    assert msg.startswith("ShardingTypeError"), msg
    assert ".at[...].get(out_sharding=)" in msg
