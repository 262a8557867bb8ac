"""The port's recurrent archs against the JAX package: rwkv6-7b (RWKV-6's
WKV scan, ``repro_torch.models.rwkv6``) and zamba2-1.2b (Mamba-2's SSD
scan with a shared attention block through kernel B4,
``repro_torch.models.mamba2`` and ``hybrid``).

Params come from ``repro.models.model.init(PRNGKey(0), cfg)`` on the
smoke configs and are carried into the port with
``repro_torch.carry.lm_params_from_reference``; a layer's params and its
inputs are made with numpy from a seed and handed to both. The port runs
on the CPU, where B4 is its plain version. The reference runs jitted and,
in bf16, compiled with ``xla_allow_excess_precision`` off (so a fused
bf16 chain rounds at each operation, as the port does), or op by op.

Tolerances, each with its reason:

  - float32, 1e-5 · max(1, max |reference|) (rtol and atol): the scans'
    terms are the reference's, summed in f32 in other orders (chunks
    batched, matmuls in place of einsums, torch's GEMMs against XLA's:
    zamba2's first in_proj already differs by 1.2e-6), and four Mamba
    layers and two attention sites carry that into the logits: 1.3e-5
    apart at |logit| up to ~3 (the state h reaches ~11).
  - bfloat16, 3e-2 · max(1, max |reference|) (``test_torch_lm.py``'s
    rule): every layer rounds to bf16, and an f32 sum in another order
    can round an entry one ulp the other way, which later roundings
    carry; a greedy token may differ only where the reference's top-2
    margin at that step is below that tolerance.
  - the recurrent rule (a prefill over S+1 tokens against a prefill over
    S and one decode step) and chunk-size invariance, port against port:
    f32 within 1e-5, bf16 within ``tests/test_recurrent_consistency.py``'s
    rtol 3e-2 and atol 5e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.distributed.meshctx import single_device_ctx
from repro.models import hybrid as RH
from repro.models import mamba2 as RMB
from repro.models import model as RM
from repro.models import rwkv6 as RW
from repro.serve import step as ref_step
from repro_torch.carry import lm_params_from_reference
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as launcher
from repro_torch.models import hybrid as TH
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TMB
from repro_torch.models import model as TM
from repro_torch.models import rwkv6 as TW
from repro_torch.serve import step

torch.set_num_threads(2)
F32_TOL = 1e-5
BF16_TOL = 3e-2
ARCHS = ["rwkv6-7b", "zamba2-1.2b"]
DTYPE_NAMES = ["float32", "bfloat16"]
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}
# the projections of a layer (the config's dtype); its other leaves are f32
WEIGHTS = ("wA", "wB", "wr", "wk", "wv", "wg", "wo", "in_proj", "out_proj")
FULL_SHAPES = {  # (family, n_layers, d_model, n_heads, n_kv_heads, head_dim,
    #              d_ff, vocab, d_inner, ssm_state, attn_every)
    "rwkv6-7b": ("ssm", 32, 4096, 64, 64, 64, 14_336, 65_536, 8192, 0, 0),
    "zamba2-1.2b": ("hybrid", 38, 2048, 32, 32, 64, 8192, 32_000, 4096, 64,
                    6)}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _cfgs(arch, dtype="float32", **kw):
    ref = dataclasses.replace(ref_registry.get_smoke_config(arch),
                              dtype=dtype, **kw)
    return ref, ModelConfig(**dataclasses.asdict(ref))


def _params(arch, dtype, seed=0, **kw):
    ref_cfg, cfg = _cfgs(arch, dtype, **kw)
    ref = RM.init(jax.random.PRNGKey(seed), ref_cfg)
    return ref, lm_params_from_reference(jax.tree.map(np.asarray, ref), cfg,
                                         "cpu")


def _pair(rng, shape, dtype="float32", scale=1.0, offset=0.0):
    """The same random array for both packages, in ``dtype``."""
    np_dt, t_dt = DTYPES[dtype]
    a = (rng.standard_normal(shape) * scale + offset).astype(np.float32)
    a = a.astype(np_dt)
    return jnp.asarray(a), torch.from_numpy(a.astype(np.float32)).to(t_dt)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _tol(dtype, want):
    scale = max(1.0, float(np.abs(_np(want)).max()))
    return (F32_TOL if dtype == "float32" else BF16_TOL) * scale


def _close(got, want, dtype):
    tol = _tol(dtype, want)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _rand_layer(ref_stack, rng, dtype):
    """Layer 0 of a reference stack with every leaf drawn anew (weights
    at their init's spread, f32 leaves ~N(0, 0.5²) around their init
    value), as (reference dict, port dict): so u, the lerp coefficients,
    the decay base, A_log, D and dt_bias are not their constant inits."""
    ref, mine = {}, {}
    for name, leaf in _flat(ref_stack):
        arr = np.asarray(leaf[0]).astype(np.float32)
        if name.split(".")[-1] in WEIGHTS:
            j, t = _pair(rng, arr.shape, dtype, float(arr.std()))
        else:
            j, t = _pair(rng, arr.shape, "float32", 0.5, 0.0)
            j, t = j + jnp.asarray(arr), t + torch.from_numpy(arr.copy())
        ref_node, my_node = ref, mine
        *path, last = name.split(".")
        for key in path:
            ref_node, my_node = (ref_node.setdefault(key, {}),
                                 my_node.setdefault(key, {}))
        ref_node[last], my_node[last] = j, t
    return ref, mine


def _ref_fn(fn, dtype):
    """``fn`` jitted, in bf16 compiled without XLA's excess precision."""
    jitted = jax.jit(fn)
    if dtype != "bfloat16":
        return jitted
    compiled = {}

    def run(*args):
        key = str(jax.tree.map(lambda a: (jnp.shape(a), jnp.result_type(a)),
                               args))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return compiled[key](*args)
    return run


def _ref_prefill(ref_cfg):
    ctx = single_device_ctx()
    return _ref_fn(lambda p, b: RM.apply_prefill(p, ref_cfg, ctx, b),
                   ref_cfg.dtype)


def _ref_decode(ref_cfg):
    ctx = single_device_ctx()
    return _ref_fn(lambda p, b, c, i: RM.apply_decode(p, ref_cfg, ctx, b, c,
                                                      i), ref_cfg.dtype)


def _grow(ref_cfg, ref_cache, B, max_len):
    """The reference's prefill cache in a cache of ``max_len`` positions
    (what its ``generate`` does for the transformer families only)."""
    return jax.tree.map(
        lambda dst, src: jax.lax.dynamic_update_slice(
            dst, src.astype(dst.dtype), (0,) * src.ndim)
        if dst.shape != src.shape else src,
        RM.init_cache(ref_cfg, B, max_len), ref_cache)


def _prompt(B=2, S=37, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _t(tokens):
    return torch.from_numpy(tokens)


# ---------------------------------------------------------------------------
# configs, registry, carry, init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    for mine, ref in ((registry.get_config(arch),
                       ref_registry.get_config(arch)),
                      (registry.get_smoke_config(arch),
                       ref_registry.get_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert (mine.d_inner, mine.is_attention_free, mine.q_dim) == (
            ref.d_inner, ref.is_attention_free, ref.q_dim)
    full = registry.get_config(arch)
    assert (full.family, full.n_layers, full.d_model, full.n_heads,
            full.n_kv_heads, full.head_dim, full.d_ff, full.vocab_size,
            full.d_inner, full.ssm_state, full.attn_every) == FULL_SHAPES[arch]
    assert full.is_attention_free == (arch == "rwkv6-7b")
    assert arch in registry.ARCH_NAMES


def _ref_layers(arch, ref):
    if arch == "rwkv6-7b":
        return ref["blocks"], "blocks"
    return ref["mamba"], "mamba"


@pytest.mark.parametrize("arch", ARCHS)
def test_carry_keeps_dtypes_and_bits(arch):
    ref, params = _params(arch, "bfloat16")
    _, cfg = _cfgs(arch, "bfloat16")
    stack, key = _ref_layers(arch, ref)
    assert len(params[key]) == cfg.n_layers
    for i, layer in enumerate(params[key]):
        for name, t in _flat(layer):
            want = stack
            for part in name.split("."):
                want = want[part]
            want = np.asarray(want[i])
            assert tuple(t.shape) == want.shape, name
            assert t.dtype == (torch.float32 if want.dtype == np.float32
                               else torch.bfloat16), name
            np.testing.assert_array_equal(_np(t), want.astype(np.float32))
    f32 = {"rwkv6-7b": ["ln1", "ln2", "tm.mu_r", "tm.w0", "tm.u", "tm.ln_x",
                        "cm.mu_k"],
           "zamba2-1.2b": ["norm", "conv_w", "A_log", "D", "dt_bias",
                           "gate_norm"]}[arch]
    flat = dict(_flat(params[key][0]))
    assert all(flat[n].dtype == torch.float32 for n in f32)
    if arch == "zamba2-1.2b":
        sh = params["shared_attn"]
        assert sorted(sh) == ["attn", "ln1", "ln2", "mlp"]
        for name, t in _flat(sh):
            want = ref["shared_attn"]
            for part in name.split("."):
                want = want[part]
            np.testing.assert_array_equal(_np(t), np.asarray(want, np.float32))
        assert tuple(sh["attn"]["wq"].shape) == (cfg.d_model, cfg.q_dim)
    assert params["embed"]["table"].dtype == torch.bfloat16
    assert params["final_norm"].dtype == torch.float32
    with pytest.raises(ValueError, match="stacked layers"):
        lm_params_from_reference(
            jax.tree.map(np.asarray, ref),
            dataclasses.replace(cfg, n_layers=cfg.n_layers + 1), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_matches_the_reference_tree_and_statistics(arch):
    _, cfg = _cfgs(arch, "bfloat16")
    _, carried = _params(arch, "bfloat16")
    mine = TM.init(cfg, seed=0, device="cpu")
    leaves = lambda p: sorted((k, tuple(t.shape), str(t.dtype))  # noqa
                              for k, t in _flat({k: v for k, v in p.items()
                                                 if not isinstance(v, list)}))
    layer_leaves = lambda layers: [sorted(  # noqa: E731
        (k, tuple(t.shape), str(t.dtype)) for k, t in _flat(b))
        for b in layers]
    key = "blocks" if arch == "rwkv6-7b" else "mamba"
    assert leaves(mine) == leaves(carried)
    assert layer_leaves(mine[key]) == layer_leaves(carried[key])
    std = 1.0 / np.sqrt(cfg.d_model)
    if arch == "rwkv6-7b":
        tm = mine["blocks"][0]["tm"]
        w = tm["wr"].float()
        assert float(w.abs().max()) <= 3.0 * std * (1 + 2 ** -7)
        assert abs(float(w.std()) / std - 0.9866) < 0.05   # N(0,1) cut at ±3
        assert float(tm["wA"].float().abs().max()) <= 0.3 * std * 1.01
        assert torch.equal(tm["w0"], torch.full((cfg.d_model,), -2.0))
        assert torch.equal(tm["mu_g"], torch.full((cfg.d_model,), 0.5))
        assert not tm["u"].any()
    else:
        layer = mine["mamba"][0]
        w = layer["in_proj"].float()
        assert float(w.abs().max()) <= 3.0 * std * (1 + 2 ** -7)
        assert abs(float(layer["conv_w"].std()) - 0.5) < 0.1  # N(0,1)/sqrt(4)
        assert not layer["A_log"].any() and not layer["dt_bias"].any()
        assert torch.equal(layer["D"], torch.ones(cfg.d_inner //
                                                  cfg.ssm_headdim))
        wo = mine["shared_attn"]["attn"]["wo"].float()
        assert float(wo.abs().max()) <= 3.0 * std / np.sqrt(
            2 * cfg.n_layers) * (1 + 2 ** -7)
    assert abs(float(mine["embed"]["table"].float().std()) - 0.02) < 0.002
    again = TM.init(cfg, seed=0, device="cpu")
    assert torch.equal(again["embed"]["table"], mine["embed"]["table"])


# ---------------------------------------------------------------------------
# rwkv6, function by function
# ---------------------------------------------------------------------------
def _wkv_inputs(rng, dtype, B=2, T=24, H=3, hd=8, log_rate=-2.0):
    """Inputs of a WKV scan; the log-decays are -exp(N(log_rate, 0.5²))."""
    r, k, v = (_pair(rng, (B, T, H, hd), dtype) for _ in range(3))
    lw = _pair(rng, (B, T, H, hd), "float32", 0.5, log_rate)
    lw = (-jnp.exp(lw[0]), -torch.exp(lw[1]))         # log-decays <= 0
    u = _pair(rng, (H, hd))
    state = _pair(rng, (B, H, hd, hd), "float32", 0.3)
    return r, k, v, lw, u, state


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("d_bytes", [TW.D_BYTES, 1])
@pytest.mark.parametrize("log_rate", [-2.0, 3.0])
def test_wkv_chunked(dtype, d_bytes, log_rate, monkeypatch):
    """3 chunks of 8 from a nonzero state; ``d_bytes`` 1 builds the decay
    tensor one chunk at a time. At ``log_rate`` 3 a step decays by
    ~exp(-20), so exp(cum_{t-1} - cum_s) overflows to inf for s >= t,
    where the port masks the scores and not the decay tensor."""
    monkeypatch.setattr(TW, "D_BYTES", d_bytes)
    rng = np.random.default_rng(10)
    r, k, v, lw, u, state = _wkv_inputs(rng, dtype, log_rate=log_rate)
    want, want_s = RW._wkv_chunked(r[0], k[0], v[0], lw[0], u[0], state[0], 8)
    got, got_s = TW._wkv_chunked(r[1], k[1], v[1], lw[1], u[1], state[1], 8)
    assert got.dtype == DTYPES[dtype][1] and got_s.dtype == torch.float32
    assert torch.isfinite(got).all()
    _close(got, want, dtype)
    _close(got_s, want_s, "float32")


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
def test_wkv_step_continues_the_chunked_scan(dtype):
    rng = np.random.default_rng(11)
    r, k, v, lw, u, state = _wkv_inputs(rng, dtype, T=1)
    want, want_s = RW._wkv_step(r[0][:, 0], k[0][:, 0], v[0][:, 0],
                                lw[0][:, 0], u[0], state[0])
    got, got_s = TW._wkv_step(r[1][:, 0], k[1][:, 0], v[1][:, 0],
                              lw[1][:, 0], u[1], state[1])
    _close(got, want, dtype)
    _close(got_s, want_s, "float32")
    # one token through the chunked form is the same step
    one, one_s = TW._wkv_chunked(r[1], k[1], v[1], lw[1], u[1], state[1], 64)
    _close(one[:, 0], got, dtype)
    _close(one_s, got_s, "float32")


def _rwkv_layer(dtype, seed):
    ref_cfg, cfg = _cfgs("rwkv6-7b", dtype)
    ref = RM.init(jax.random.PRNGKey(0), ref_cfg)
    p, tp = _rand_layer(ref["blocks"], np.random.default_rng(seed), dtype)
    return ref_cfg, cfg, p, tp


def _rwkv_state(rng, cfg, dtype, B):
    H, hd = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    wkv = _pair(rng, (B, H, hd, hd), "float32", 0.3)
    tm_x = _pair(rng, (B, cfg.d_model), dtype)
    cm_x = _pair(rng, (B, cfg.d_model), dtype)
    return ({"wkv": wkv[0], "tm_x": tm_x[0], "cm_x": cm_x[0]},
            {"wkv": wkv[1], "tm_x": tm_x[1], "cm_x": cm_x[1]})


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("single", [False, True])
def test_time_mix(dtype, single):
    ref_cfg, cfg, p, tp = _rwkv_layer(dtype, 12)
    rng = np.random.default_rng(13)
    x, tx = _pair(rng, (2, 1 if single else 16, cfg.d_model), dtype)
    st, tst = _rwkv_state(rng, cfg, dtype, 2)
    want, want_st = _ref_fn(lambda p, x, s: RW._time_mix(
        p, x, ref_cfg, s, chunk=8, single=single), dtype)(p["tm"], x, st)
    got, got_st = TW._time_mix(tp["tm"], tx, cfg, tst, chunk=8,
                               single=single)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, dtype)
    _close(got_st["wkv"], want_st["wkv"], "float32" if dtype == "float32"
           else dtype)
    _close(got_st["tm_x"], want_st["tm_x"], "float32")   # a copy of x


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("single", [False, True])
def test_channel_mix(dtype, single):
    ref_cfg, cfg, p, tp = _rwkv_layer(dtype, 14)
    rng = np.random.default_rng(15)
    x, tx = _pair(rng, (2, 1 if single else 16, cfg.d_model), dtype)
    st, tst = _rwkv_state(rng, cfg, dtype, 2)
    want, want_st = _ref_fn(lambda p, x, s: RW._channel_mix(
        p, x, s, single=single), dtype)(p["cm"], x, st)
    got, got_st = TW._channel_mix(tp["cm"], tx, tst, single=single)
    _close(got, want, dtype)
    _close(got_st["cm_x"], want_st["cm_x"], "float32")


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("single", [False, True])
def test_rwkv6_block_apply(dtype, single):
    ref_cfg, cfg, p, tp = _rwkv_layer(dtype, 16)
    rng = np.random.default_rng(17)
    x, tx = _pair(rng, (2, 1 if single else 24, cfg.d_model), dtype)
    st, tst = _rwkv_state(rng, cfg, dtype, 2)
    want, want_st = _ref_fn(lambda p, x, s: RW.block_apply(
        p, x, ref_cfg, s, chunk=8, single=single), dtype)(p, x, st)
    got, got_st = TW.block_apply(tp, tx, cfg, tst, chunk=8, single=single)
    _close(got, want, dtype)
    assert sorted(got_st) == sorted(want_st) == ["cm_x", "tm_x", "wkv"]
    for name in got_st:
        _close(got_st[name], want_st[name], dtype)


# ---------------------------------------------------------------------------
# mamba2, function by function
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("T", [1, 9])
def test_causal_conv(dtype, T):
    """The prefill form (T 9) and a decode step (T 1, the reference's
    ``single``), from a nonzero carried state; bf16 rounds the f32 sum of
    the four taps once, as the reference's einsum does: bit for bit."""
    rng = np.random.default_rng(20 + T)
    x, tx = _pair(rng, (2, T, 24), dtype)
    w, tw = _pair(rng, (TMB.CONV_K, 24), "float32", 0.5)
    s, ts = _pair(rng, (2, TMB.CONV_K - 1, 24), dtype)
    want, want_s = RMB._causal_conv(x, w, s, single=T == 1)
    got, got_s = TMB._causal_conv(tx, tw, ts)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, "float32" if dtype == "float32" else 0.0)
    _close(got_s, want_s, "float32")


def _ssd_inputs(rng, dtype, B=2, T=24, nh=3, hd=8, N=5):
    x = _pair(rng, (B, T, nh, hd), dtype)
    dt = _pair(rng, (B, T, nh), "float32", 0.3)
    dt = (jax.nn.softplus(dt[0]), torch.nn.functional.softplus(dt[1]))
    Bm, Cm = (_pair(rng, (B, T, N), dtype) for _ in range(2))
    a = _pair(rng, (nh,), "float32", 0.5)
    a_log = (-jnp.exp(a[0]) * dt[0], -torch.exp(a[1]) * dt[1])
    h = _pair(rng, (B, nh, hd, N), "float32", 0.3)
    return x, dt, Bm, Cm, a_log, h


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
def test_ssd_chunked(dtype):
    rng = np.random.default_rng(24)
    x, dt, Bm, Cm, a_log, h = _ssd_inputs(rng, dtype)
    want, want_h = RMB._ssd_chunked(x[0], dt[0], Bm[0], Cm[0], a_log[0],
                                    h[0], 8)
    got, got_h = TMB._ssd_chunked(x[1], dt[1], Bm[1], Cm[1], a_log[1], h[1],
                                  8)
    assert got.dtype == DTYPES[dtype][1] and got_h.dtype == torch.float32
    _close(got, want, dtype)
    _close(got_h, want_h, "float32")


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
def test_ssd_step_continues_the_chunked_scan(dtype):
    rng = np.random.default_rng(25)
    x, dt, Bm, Cm, a_log, h = _ssd_inputs(rng, dtype, T=1)
    want, want_h = RMB._ssd_step(x[0][:, 0], dt[0][:, 0], Bm[0][:, 0],
                                 Cm[0][:, 0], a_log[0][:, 0], h[0])
    got, got_h = TMB._ssd_step(x[1][:, 0], dt[1][:, 0], Bm[1][:, 0],
                               Cm[1][:, 0], a_log[1][:, 0], h[1])
    _close(got, want, dtype)
    _close(got_h, want_h, "float32")
    one, one_h = TMB._ssd_chunked(x[1], dt[1], Bm[1], Cm[1], a_log[1], h[1],
                                  64)
    _close(one[:, 0], got, dtype)
    _close(one_h, got_h, "float32")


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("single", [False, True])
def test_mamba2_block_apply(dtype, single):
    ref_cfg, cfg = _cfgs("zamba2-1.2b", dtype)
    ref = RM.init(jax.random.PRNGKey(0), ref_cfg)
    p, tp = _rand_layer(ref["mamba"], np.random.default_rng(26), dtype)
    rng = np.random.default_rng(27)
    B, T = 2, 1 if single else 24
    x, tx = _pair(rng, (B, T, cfg.d_model), dtype)
    nh = cfg.d_inner // cfg.ssm_headdim
    h, th = _pair(rng, (B, nh, cfg.ssm_headdim, cfg.ssm_state), "float32",
                  0.3)
    c, tc = _pair(rng, (B, TMB.CONV_K - 1, cfg.d_inner + 2 * cfg.ssm_state),
                  dtype)
    want, want_st = _ref_fn(lambda p, x, s: RMB.block_apply(
        p, x, ref_cfg, s, chunk=8, single=single), dtype)(
            p, x, {"h": h, "conv": c})
    got, got_st = TMB.block_apply(tp, tx, cfg, {"h": th, "conv": tc},
                                  chunk=8, single=single)
    _close(got, want, dtype)
    _close(got_st["h"], want_st["h"], dtype)
    _close(got_st["conv"], want_st["conv"], "float32")


def test_hybrid_segments_and_sites():
    for cfg, ref_cfg in ((registry.get_config("zamba2-1.2b"),
                          ref_registry.get_config("zamba2-1.2b")),
                         (registry.get_smoke_config("zamba2-1.2b"),
                          ref_registry.get_smoke_config("zamba2-1.2b"))):
        assert TH.segments(cfg) == RH.segments(ref_cfg)
        assert TH.n_attn_sites(cfg) == RH.n_attn_sites(ref_cfg)
    full = registry.get_config("zamba2-1.2b")
    assert TH.segments(full) == [(0, 6), (6, 12), (12, 18), (18, 24),
                                 (24, 30), (30, 36), (36, 38)]
    assert [TH._site(full, b) for _, b in TH.segments(full)] == \
        [0, 1, 2, 3, 4, 5, None]
    smoke = registry.get_smoke_config("zamba2-1.2b")
    assert TH.segments(smoke) == [(0, 2), (2, 4)]
    assert TH.n_attn_sites(smoke) == 2


def test_chunks_must_divide_the_prompt():
    """The reference asserts T % C == 0 with C = min(chunk, T); the port
    raises, and never pads."""
    assert TL.chunk_split(37, 64) == 37 and TL.chunk_split(1024, 64) == 64
    rng = np.random.default_rng(28)
    r, k, v, lw, u, state = _wkv_inputs(rng, "float32", T=24)
    with pytest.raises(ValueError, match="chunks of 16"):
        TW._wkv_chunked(r[1], k[1], v[1], lw[1], u[1], state[1], 16)
    x, dt, Bm, Cm, a_log, h = _ssd_inputs(rng, "float32", T=24)
    with pytest.raises(ValueError, match="chunks of 16"):
        TMB._ssd_chunked(x[1], dt[1], Bm[1], Cm[1], a_log[1], h[1], 16)
    for arch in ARCHS:
        _, cfg = _cfgs(arch)
        params = TM.init(cfg, seed=0, device="cpu")
        with pytest.raises(ValueError, match="multiple of the chunk"):
            TM.apply_prefill(params, cfg, {"tokens": _t(_prompt(S=70))})


# ---------------------------------------------------------------------------
# the slice as a whole: prefill, decode, generate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_the_reference(arch, dtype):
    """Prefill logits and carried state at S 37 (one chunk of 37), then
    three decode steps, against the reference (zamba2's on a grown
    cache)."""
    ref_cfg, cfg = _cfgs(arch, dtype)
    ref, params = _params(arch, dtype)
    tokens = _prompt()
    B, S = tokens.shape
    want, want_aux, ref_cache = _ref_prefill(ref_cfg)(
        ref, {"tokens": jnp.asarray(tokens)})
    got, aux, cache = TM.apply_prefill(params, cfg, {"tokens": _t(tokens)})
    assert tuple(got.shape) == (B, S, 256) and float(aux) == 0.0
    _close(got, want, dtype)
    last, _, _ = TM.apply_prefill(params, cfg, {"tokens": _t(tokens)},
                                  last_only=True)
    _close(last, got[:, -1:], "float32")
    for name, t in _flat(cache):
        want_t = dict(_flat(ref_cache))[name]
        assert tuple(t.shape) == want_t.shape, name
        assert t.dtype == DTYPES[str(want_t.dtype)][1], name
        _close(t, want_t, dtype)

    max_len = S + 3
    ref_cache = _grow(ref_cfg, ref_cache, B, max_len)
    cache = step.decode_cache(cfg, cache, B, S, max_len, "cpu")
    ref_decode = _ref_decode(ref_cfg)
    for i in range(3):
        step_tok = _prompt(B, 1, seed=10 + i)
        want, _, ref_cache = ref_decode(ref, {"tokens": jnp.asarray(step_tok)},
                                        ref_cache, jnp.int32(S + i))
        got, _, cache = TM.apply_decode(params, cfg,
                                        {"tokens": _t(step_tok)}, cache,
                                        S + i)
        assert tuple(got.shape) == (B, 1, 256)
        _close(got, want, dtype)
    for name, t in _flat(cache):
        _close(t, dict(_flat(ref_cache))[name], dtype)


def _ref_generate(ref, ref_cfg, prompt, max_new, max_len):
    """The reference's greedy loop, its prefill and decode compiled by
    ``_ref_fn``, on a cache grown to ``max_len`` (its ``generate`` grows
    it for the transformer families only, ROADMAP C20): (tokens [B,
    max_new], each step's top-2 margin [B, max_new], each step's
    tolerance)."""
    prefill, decode = _ref_prefill(ref_cfg), _ref_decode(ref_cfg)
    B, S = prompt.shape
    logits, _, cache = prefill(ref, {"tokens": jnp.asarray(prompt)})
    logits = logits[:, -1:]
    if ref_cfg.family == "hybrid":
        cache = _grow(ref_cfg, cache, B, max_len)
    toks, margins, tols = [], [], []
    for i in range(max_new):
        if i:
            logits, _, cache = decode(ref, {"tokens": toks[-1]}, cache,
                                      jnp.int32(S + i - 1))
        top2 = np.sort(np.asarray(logits[:, -1], np.float32), axis=-1)
        margins.append(top2[:, -1] - top2[:, -2])
        tols.append(_tol(ref_cfg.dtype, logits))
        toks.append(ref_step.sample(logits, None))
    return (np.asarray(jnp.concatenate(toks, axis=1)),
            np.stack(margins, 1), tols)


def _first_part(want, got):
    """The first (step, row) where two greedy streams differ, or None."""
    diff = np.argwhere(want != got)
    if diff.size == 0:
        return None
    b, t = diff[np.lexsort((diff[:, 0], diff[:, 1]))][0]
    return int(t), int(b)


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_the_reference_greedy_tokens(arch, dtype):
    """``step.generate`` from a 37-token prompt, 6 greedy tokens, equal
    to the reference's model decoded greedily (zamba2 on a grown cache):
    exactly in f32, in bf16 apart from the first step where the
    reference's top-2 margin is below the logits' tolerance. rwkv6's
    loop is the reference's ``generate`` (checked here too); B4 is its
    plain version on the CPU and counts no launch."""
    ref_cfg, cfg = _cfgs(arch, dtype)
    ref, params = _params(arch, dtype)
    prompt = _prompt()
    max_new = 6
    max_len = prompt.shape[1] + max_new
    want, margins, tols = _ref_generate(ref, ref_cfg, prompt, max_new,
                                        max_len)
    if arch == "rwkv6-7b":
        plain = ref_step.generate(ref, ref_cfg, single_device_ctx(),
                                  jnp.asarray(prompt), max_new=max_new,
                                  max_len=max_len)
        part = _first_part(want, np.asarray(plain))
        assert part is None or margins[part[1], part[0]] < tols[part[0]]
    before = fa.flash_attention_gqa.launches
    got = step.generate(params, cfg, prompt, max_new=max_new,
                        max_len=max_len, device="cpu")
    assert fa.flash_attention_gqa.launches == before
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    part = _first_part(want, got.numpy())
    if part:
        t, b = part
        assert margins[b, t] < tols[t], (b, t, margins[b, t])


# ---------------------------------------------------------------------------
# ROADMAP C20: the reference's generate decodes the hybrid on a prompt-
# sized cache
# ---------------------------------------------------------------------------
def _c20_case():
    """zamba2's smoke config in bf16 (the reference's own), B 2, S 16: the
    reference's prefill cache, its first decode step on that cache as its
    ``generate`` passes it, and on a grown cache."""
    ref_cfg, cfg = _cfgs("zamba2-1.2b", "bfloat16")
    ref, params = _params("zamba2-1.2b", "bfloat16")
    prompt = _prompt(2, 16, seed=7)
    B, S = prompt.shape
    logits, _, raw = _ref_prefill(ref_cfg)(ref,
                                           {"tokens": jnp.asarray(prompt)})
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    decode = _ref_decode(ref_cfg)
    on_raw, _, raw_after = decode(ref, {"tokens": tok}, raw, jnp.int32(S))
    grown = _grow(ref_cfg, raw, B, S + 4)
    on_grown, _, _ = decode(ref, {"tokens": tok}, grown, jnp.int32(S))
    return (ref_cfg, cfg, ref, params, prompt, raw, raw_after, on_raw,
            on_grown)


def test_c20_reference_generate_overwrites_the_last_prompt_key():
    """The reference's ``generate`` hands the hybrid's prompt-sized KV
    cache to decode; the write at position S clamps to S-1, so the first
    generated token's key replaces the last prompt token's, and the
    logits part from a decode on a grown cache by more than the bf16
    limit."""
    (ref_cfg, _, ref, _, prompt, raw, raw_after, on_raw,
     on_grown) = _c20_case()
    S = prompt.shape[1]
    assert raw["k"].shape[2] == S
    assert not np.array_equal(np.asarray(raw_after["k"][:, :, S - 1]),
                              np.asarray(raw["k"][:, :, S - 1]))
    np.testing.assert_array_equal(np.asarray(raw_after["k"][:, :, :S - 1]),
                                  np.asarray(raw["k"][:, :, :S - 1]))
    gap = float(np.abs(_np(on_raw) - _np(on_grown)).max())
    assert gap > _tol("bfloat16", on_grown), gap
    # ... and that is what its generate emits after the first token
    toks = np.asarray(ref_step.generate(ref, ref_cfg, single_device_ctx(),
                                        jnp.asarray(prompt), max_new=2,
                                        max_len=S + 2))
    assert toks[:, 1].tolist() == np.argmax(_np(on_raw)[:, -1],
                                            -1).tolist()


def test_c20_port_generate_decodes_on_a_grown_cache():
    """The port's ``generate`` copies the hybrid's k and v into a cache of
    ``max_len`` positions: its first decode logits are the reference's on
    a grown cache, and a prompt-sized cache raises rather than clamps."""
    (_, cfg, _, params, prompt, _, _, _, on_grown) = _c20_case()
    B, S = prompt.shape
    logits, kv = step.make_prefill(cfg)(params, {"tokens": _t(prompt)})
    tok = step.sample(logits)
    cache = step.decode_cache(cfg, kv, B, S, S + 4, "cpu")
    assert tuple(cache["k"].shape[2:3]) == (S + 4,)
    got, _, _ = TM.apply_decode(params, cfg, {"tokens": tok}, cache, S)
    _close(got, on_grown, "bfloat16")
    logits, kv = step.make_prefill(cfg)(params, {"tokens": _t(prompt)})
    with pytest.raises(IndexError):
        TM.apply_decode(params, cfg, {"tokens": tok}, kv, S)


# ---------------------------------------------------------------------------
# the recurrent rule and chunk-size invariance (tests/test_recurrent_
# consistency.py, on the port)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_prefill_exactly(arch, dtype):
    """logits(prefill S+1)[last] == logits(decode step after prefill S)."""
    _, cfg = _cfgs(arch, dtype)
    _, params = _params(arch, dtype)
    B, S = 2, 16
    toks = _prompt(B, S + 1, seed=1)
    full, _, _ = TM.apply_prefill(params, cfg, {"tokens": _t(toks)})
    _, _, kv = TM.apply_prefill(params, cfg, {"tokens": _t(toks[:, :S])})
    cache = step.decode_cache(cfg, kv, B, S, S + 4, "cpu")
    got, _, _ = TM.apply_decode(params, cfg, {"tokens": _t(toks[:, S:])},
                                cache, S)
    tol = (F32_TOL, F32_TOL) if dtype == "float32" else (3e-2, 5e-2)
    np.testing.assert_allclose(_np(got[:, 0]), _np(full[:, -1]), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_size_invariance(arch, dtype):
    """The chunked scans' result must not depend on the chunk size."""
    _, cfg = _cfgs(arch, dtype)
    _, params = _params(arch, dtype)
    toks = {"tokens": _t(_prompt(2, 24, seed=2))}
    mod = TW if arch == "rwkv6-7b" else TH
    l4, _, s4 = mod.forward(params, cfg, toks, chunk=4)
    l12, _, s12 = mod.forward(params, cfg, toks, chunk=12)
    tol = (F32_TOL, F32_TOL) if dtype == "float32" else (3e-2, 3e-2)
    np.testing.assert_allclose(_np(l4), _np(l12), rtol=tol[0], atol=tol[1])
    if dtype == "float32":
        for (name, a), (_, b) in zip(_flat(s4), _flat(s12)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=tol[0],
                                       atol=tol[1], err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_recurrent_archs_on_the_cpu(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "12",
            "--max-new", "4", "--device", "cpu"]
    run = launcher.main(argv)
    assert tuple(run.tokens.shape) == (2, 4)
    assert int(run.tokens.min()) >= 0 and int(run.tokens.max()) < 256
    assert f"{arch}-smoke on cpu" in capsys.readouterr().out
    torch.testing.assert_close(launcher.main(argv).tokens, run.tokens,
                               rtol=0, atol=0)
