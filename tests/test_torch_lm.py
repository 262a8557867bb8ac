"""The port's LM serving path against the JAX package: qwen2-0.5b, the
Qwen3 family and internlm2, gemma3 (sliding window, hd 256) and kimi-k2
(a leading dense layer ahead of the MoE layers).

Params come from ``repro.models.model.init(PRNGKey(0), cfg)`` and are
carried into the port with ``repro_torch.carry.lm_params_from_reference``;
layer inputs are made with numpy from a seed and handed to both. The
port runs on the CPU, where prefill attention is kernel B4's plain
version (the reference runs its jnp blockwise attention).

Tolerances, each with its reason:

  - float32, 1e-5 (rtol and atol): the two sum the same products in
    other orders (matmuls, attention tiles); logits of the smoke model
    are below 1, and their differences measure ~1e-6.
  - bfloat16, 3e-2 on logits: every layer rounds to bf16 (one ulp at
    0.5 is 2^-8), and attention outputs that differ by one ulp (f32 sums
    in another order, then rounded) move every later layer's rounding;
    logits measure up to ~1e-2 apart. Greedy tokens must agree up to the
    first step where the reference's top-2 margin is below that
    tolerance; after it the two continue from different tokens.
  - Layers whose arithmetic is the same on both sides (norms, the
    projections, the FFN, embeddings) are held bit for bit in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import qwen2_0p5b as ref_qwen2
from repro.configs import registry as ref_registry
from repro.distributed.meshctx import single_device_ctx
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import transformer as RT
from repro.serve import step as ref_step
from repro_torch.carry import lm_params_from_reference
from repro_torch.configs import qwen2_0p5b, registry
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as launcher
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serve import step

torch.set_num_threads(2)
F32_TOL = 1e-5
BF16_TOL = 3e-2
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _cfgs(dtype):
    return (dataclasses.replace(ref_qwen2.smoke_config(), dtype=dtype),
            dataclasses.replace(qwen2_0p5b.smoke_config(), dtype=dtype))


def _params(dtype, seed=0):
    ref_cfg, cfg = _cfgs(dtype)
    ref = RM.init(jax.random.PRNGKey(seed), ref_cfg)
    return ref, lm_params_from_reference(jax.tree.map(np.asarray, ref), cfg,
                                         "cpu")


def _pair(rng, shape, dtype="float32", scale=1.0):
    """The same random array for both packages, in ``dtype``."""
    np_dt, t_dt = DTYPES[dtype]
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a.astype(np_dt)), torch.from_numpy(a).to(t_dt)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------
def test_configs_equal_the_reference_field_for_field():
    for mine, ref in ((qwen2_0p5b.config(), ref_qwen2.config()),
                      (qwen2_0p5b.smoke_config(), ref_qwen2.smoke_config())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert (mine.q_dim, mine.kv_dim) == (ref.q_dim, ref.kv_dim)
    full = registry.get_config("qwen2-0.5b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size) == (
        24, 896, 14, 2, 64, 4864, 151_936)


def test_an_unknown_arch_raises_listing_all_ten():
    assert len(registry.ARCH_NAMES) == 10
    for get in (registry.get_config, registry.get_smoke_config):
        with pytest.raises(KeyError, match="unknown arch 'gpt-2'") as err:
            get("gpt-2")
        for name in ref_registry.ARCH_NAMES:
            assert repr(name) in str(err.value)


@pytest.mark.parametrize("name", ref_registry.ARCH_NAMES)
def test_check_supported_refuses_only_the_logit_softcap(name):
    """Every transformer-family config runs as it is (the recurrent ones
    go to their own modules); a logit softcap is refused in any."""
    cfg = ModelConfig(**dataclasses.asdict(ref_registry.get_smoke_config(
        name)))
    if cfg.family in TT.FAMILIES:
        TT.check_supported(cfg)
        TT.check_supported(registry.get_config(name))
    with pytest.raises(NotImplementedError, match="logit softcap"):
        TT.check_supported(dataclasses.replace(cfg, attn_logit_softcap=30.0))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(1)
    x, tx = _pair(rng, (2, 5, 64), dtype, 3.0)
    s, ts = _pair(rng, (64,))
    _close(TL.rms_norm(tx, ts, 1e-6), RL.rms_norm(x, s, 1e-6),
           F32_TOL if dtype == "float32" else 0.0)


@pytest.mark.parametrize("positions", ["1d", "2d"])
def test_rope(positions):
    rng = np.random.default_rng(2)
    x, tx = _pair(rng, (2, 9, 3, 16))
    pos = np.arange(9, dtype=np.int32) if positions == "1d" else \
        rng.integers(0, 1000, (2, 9)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        # angles up to 1000 rad: one ulp of a frequency moves them ~1e-4,
        # so torch's and XLA's pow/sin/cos may differ there by that much
        tol = F32_TOL if positions == "1d" else 2e-4
        _close(TL.rope(tx, torch.from_numpy(pos), theta),
               RL.rope(x, jnp.asarray(pos), theta), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_qkv_with_f32_bias(dtype):
    ref_cfg, cfg = _cfgs(dtype)
    rng = np.random.default_rng(3)
    p, tp = {}, {}
    for name, shape in (("wq", (64, cfg.q_dim)), ("wk", (64, cfg.kv_dim)),
                        ("wv", (64, cfg.kv_dim))):
        p[name], tp[name] = _pair(rng, shape, dtype, 0.125)
    for name, dim in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                      ("bv", cfg.kv_dim)):
        p[name], tp[name] = _pair(rng, (dim,))       # biases stay f32
    x, tx = _pair(rng, (2, 7, 64), dtype)
    got, want = TL.attn_qkv(tp, tx, cfg), RL.attn_qkv(p, x, ref_cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == DTYPES[dtype][1]
        _close(g, w, F32_TOL if dtype == "float32" else 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_apply_swiglu(dtype):
    rng = np.random.default_rng(4)
    p, tp = {}, {}
    for name, shape in (("w_gate", (64, 128)), ("w_up", (64, 128)),
                        ("w_down", (128, 64))):
        p[name], tp[name] = _pair(rng, shape, dtype, 0.125)
    x, tx = _pair(rng, (2, 7, 64), dtype)
    _close(TL.ffn_apply(tp, tx), RL.ffn_apply(p, x),
           F32_TOL if dtype == "float32" else 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cur_index", [0, 5, 15])
def test_decode_attention(dtype, cur_index):
    rng = np.random.default_rng(cur_index)
    q, tq = _pair(rng, (2, 1, 4, 16), dtype)
    k, tk = _pair(rng, (2, 16, 2, 16), dtype)
    v, tv = _pair(rng, (2, 16, 2, 16), dtype)
    got = TL.decode_attention(tq, tk, tv, cur_index)
    want = RL.decode_attention(q, k, v, jnp.int32(cur_index))
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)
    if cur_index == 0:            # only position 0 is valid
        _close(got[:, 0].reshape(2, 2, 2, 16)[:, :, 0], tv[:, 0], 0.0)


def test_prefill_attention_matches_blockwise_attention():
    rng = np.random.default_rng(6)
    q, tq = _pair(rng, (2, 70, 4, 16))
    k, tk = _pair(rng, (2, 70, 2, 16))
    v, tv = _pair(rng, (2, 70, 2, 16))
    _close(TL.blockwise_attention(tq, tk, tv),
           RL.blockwise_attention(q, k, v, causal=True), F32_TOL)


def test_embed_and_tied_unembed():
    ref, params = _params("bfloat16")
    tokens = np.random.default_rng(7).integers(0, 256, (2, 5)).astype(
        np.int32)
    x = TL.embed_apply(params["embed"], torch.from_numpy(tokens))
    _close(x, RL.embed_apply(ref["embed"], jnp.asarray(tokens)), 0.0)
    _close(TL.unembed_apply(params["embed"], x),
           RL.unembed_apply(ref["embed"], jnp.asarray(_np(x)).astype(
               jnp.bfloat16)), 0.0)


# ---------------------------------------------------------------------------
# init and carry
# ---------------------------------------------------------------------------
def test_carry_keeps_dtypes_orientation_and_bits():
    ref, params = _params("bfloat16")
    blocks = ref["blocks"]
    assert len(params["blocks"]) == 2
    for i, pb in enumerate(params["blocks"]):
        for group in ("attn", "mlp"):
            for name, t in pb[group].items():
                want = np.asarray(blocks[group][name][i])
                assert tuple(t.shape) == want.shape, name
                f32 = name.startswith("b")
                assert t.dtype == (torch.float32 if f32 else torch.bfloat16)
                np.testing.assert_array_equal(_np(t), want.astype(np.float32))
        assert pb["ln1"].dtype == torch.float32
    assert params["embed"]["table"].dtype == torch.bfloat16
    assert params["final_norm"].dtype == torch.float32


def test_port_init_matches_the_reference_tree_and_statistics():
    ref_cfg, cfg = _cfgs("bfloat16")
    params = TM.init(cfg, seed=0, device="cpu")
    _, carried = _params("bfloat16")
    leaves = lambda p: sorted((g, k, tuple(t.shape), str(t.dtype))
                              for b in p["blocks"] for g in ("attn", "mlp")
                              for k, t in b[g].items())
    assert leaves(params) == leaves(carried)
    w = params["blocks"][0]["mlp"]["w_gate"].float()
    std = 1.0 / np.sqrt(cfg.d_model)
    assert float(w.abs().max()) <= 3.0 * std * (1 + 2 ** -7)
    assert abs(float(w.std()) / std - 0.9866) < 0.05   # N(0,1) cut at ±3
    wo = params["blocks"][0]["attn"]["wo"].float()
    assert float(wo.abs().max()) <= 3.0 * std / 2.0 * (1 + 2 ** -7)
    assert not params["blocks"][0]["attn"]["bq"].any()
    table = params["embed"]["table"].float()
    assert abs(float(table.std()) - 0.02) < 0.002
    again = TM.init(cfg, seed=0, device="cpu")
    assert torch.equal(again["embed"]["table"], params["embed"]["table"])


# ---------------------------------------------------------------------------
# the slice as a whole: prefill, decode, generate
# ---------------------------------------------------------------------------
def _prompt(B=2, S=37, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_the_reference(dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    ref_cfg, cfg = _cfgs(dtype)
    ref, params = _params(dtype)
    ctx = single_device_ctx()
    tokens = _prompt()
    B, S = tokens.shape
    want, _, ref_kv = RM.apply_prefill(ref, ref_cfg, ctx,
                                       {"tokens": jnp.asarray(tokens)})
    got, _, kv = TM.apply_prefill(params, cfg,
                                  {"tokens": torch.from_numpy(tokens)})
    assert tuple(got.shape) == (B, S, 256)
    _close(got, want, tol)
    _close(kv["k"], ref_kv["k"], tol)
    last, _, _ = TM.apply_prefill(params, cfg,
                                  {"tokens": torch.from_numpy(tokens)},
                                  last_only=True)
    _close(last, got[:, -1:], tol)

    max_len = S + 3
    ref_cache = jax.tree.map(
        lambda dst, src: jax.lax.dynamic_update_slice(
            dst, src.astype(dst.dtype), (0,) * src.ndim),
        RM.init_cache(ref_cfg, B, max_len), ref_kv)
    cache = TM.init_cache(cfg, B, max_len, device="cpu")
    cache["k"][:, :, :S] = kv["k"]
    cache["v"][:, :, :S] = kv["v"]
    for i in range(3):
        step_tok = _prompt(B, 1, seed=10 + i)
        want, _, ref_cache = RM.apply_decode(
            ref, ref_cfg, ctx, {"tokens": jnp.asarray(step_tok)}, ref_cache,
            jnp.int32(S + i))
        got, _, cache = TM.apply_decode(
            params, cfg, {"tokens": torch.from_numpy(step_tok)}, cache, S + i)
        assert tuple(got.shape) == (B, 1, 256)
        _close(got, want, tol)
    assert not cache["k"][:, :, S + 3:].any()


def _first_mismatch_margin(ref_params, ref_cfg, prompt, ref_tokens, tokens):
    """Where the two greedy streams first differ, the reference's top-2
    margin at that step (teacher-forced on its own tokens), else None."""
    diff = np.argwhere(ref_tokens != tokens)
    if diff.size == 0:
        return None
    b, t = diff[np.lexsort((diff[:, 0], diff[:, 1]))][0]
    seq = np.concatenate([prompt, ref_tokens[:, :t]], axis=1)
    logits, _, _ = RM.apply_prefill(ref_params, ref_cfg, single_device_ctx(),
                                    {"tokens": jnp.asarray(seq)})
    top2 = np.sort(np.asarray(logits[b, -1], np.float32))[-2:]
    return float(top2[1] - top2[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_matches_the_reference_greedy_tokens(dtype):
    ref_cfg, cfg = _cfgs(dtype)
    ref, params = _params(dtype)
    prompt = _prompt()
    max_new = 6
    max_len = prompt.shape[1] + max_new
    want = np.asarray(ref_step.generate(ref, ref_cfg, single_device_ctx(),
                                        jnp.asarray(prompt), max_new=max_new,
                                        max_len=max_len))
    before = fa.flash_attention_gqa.launches
    got = step.generate(params, cfg, prompt, max_new=max_new,
                        max_len=max_len, device="cpu")
    assert fa.flash_attention_gqa.launches == before   # plain on the CPU
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        margin = _first_mismatch_margin(ref, ref_cfg, prompt, want,
                                        got.numpy())
        assert margin is None or margin < BF16_TOL, margin


def test_generate_checks_the_cache_length_and_samples_with_a_generator():
    _, cfg = _cfgs("float32")
    _, params = _params("float32")
    with pytest.raises(ValueError, match="cache"):
        step.generate(params, cfg, _prompt(), max_new=4, max_len=39,
                      device="cpu")
    a = step.generate(params, cfg, _prompt(), max_new=4, max_len=40,
                      temperature=1.0, seed=3, device="cpu")
    b = step.generate(params, cfg, _prompt(), max_new=4, max_len=40,
                      temperature=1.0, seed=3, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def test_sample_greedy_takes_the_first_of_equal_maxima():
    logits = torch.tensor([[[0.0, 2.0, 2.0, 1.0]], [[5.0, 5.0, 5.0, 5.0]]])
    assert step.sample(logits).tolist() == [[1], [0]]
    assert np.asarray(ref_step.sample(jnp.asarray(logits.numpy()), None)
                      ).tolist() == [[1], [0]]


def test_launcher_runs_on_the_cpu(capsys):
    run = launcher.main(["--arch", "qwen2-0.5b", "--smoke", "--batch", "2",
                         "--prompt-len", "12", "--max-new", "4",
                         "--device", "cpu"])
    assert tuple(run.tokens.shape) == (2, 4)
    assert run.stats["prefill_s"] > 0 and run.stats["decode_s"] > 0
    out = capsys.readouterr().out
    assert "tok/s" in out and "prefill" in out and "seq 1:" in out
    again = launcher.main(["--arch", "qwen2-0.5b", "--smoke", "--batch", "2",
                           "--prompt-len", "12", "--max-new", "4",
                           "--device", "cpu"])
    torch.testing.assert_close(again.tokens, run.tokens, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the Qwen3 family and internlm2: qk-norm, head dim 128, the MoE block
# ---------------------------------------------------------------------------
# bf16 logits of the untied heads (internlm2, qwen3-moe) reach ~4, where
# one bf16 ulp is 2^-5: the qwen2 tolerance is taken relative to the
# logits' scale, BF16_TOL · max(1, max |reference logit|); measured
# 0.047 and 0.074 at max |logit| 4.2 and 4.1 (limits 0.127 and 0.123)
NEW_ARCHS = ["qwen3-4b", "internlm2-20b", "qwen3-moe-235b-a22b",
             "gemma3-4b", "kimi-k2-1t-a32b"]
FULL_SHAPES = {  # (n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff,
    #              vocab, n_experts, top_k)
    "qwen3-4b": (36, 2560, 32, 8, 128, 9728, 151_936, 0, 0),
    "internlm2-20b": (48, 6144, 48, 8, 128, 16_384, 92_544, 0, 0),
    "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 128, 1536, 151_936, 128, 8),
    "gemma3-4b": (34, 2560, 8, 4, 256, 10_240, 262_144, 0, 0),
    "kimi-k2-1t-a32b": (61, 7168, 64, 8, 128, 2048, 163_840, 384, 8)}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _arch_cfgs(arch, dtype):
    return (dataclasses.replace(ref_registry.get_smoke_config(arch),
                                dtype=dtype),
            dataclasses.replace(registry.get_smoke_config(arch), dtype=dtype))


def _arch_params(arch, dtype, seed=0):
    ref_cfg, cfg = _arch_cfgs(arch, dtype)
    ref = RM.init(jax.random.PRNGKey(seed), ref_cfg)
    return ref, lm_params_from_reference(jax.tree.map(np.asarray, ref), cfg,
                                         "cpu")


def _logit_tol(dtype, want):
    if dtype == "float32":
        return F32_TOL
    return BF16_TOL * max(1.0, float(np.abs(_np(want)).max()))


# How the reference runs: jitted, and in bf16 compiled without XLA's
# excess precision (``xla_allow_excess_precision`` off), so that a fused
# chain of bf16 operations rounds at each operation, as the port and the
# reference run op by op do; with it on, XLA's CPU fusions keep f32
# inside the chain. Through kimi-k2's router that moves routing choices:
# its smoke logits measure 1.65 apart the two ways (0.07 for qwen3-moe),
# the port's 0.03 from the reference compiled so.
def _ref_fn(fn, dtype):
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


def _ref_generate(ref, ref_cfg, prompt, max_new, max_len):
    """``repro.serve.step.generate`` (greedy), its prefill and decode
    steps compiled by ``_ref_fn``: (tokens [B, max_new], each step's top-2
    logit margin [B, max_new], each step's logits' tolerance)."""
    ctx = single_device_ctx()
    prefill = _ref_fn(ref_step.make_prefill(ref_cfg, ctx, jit=False),
                      ref_cfg.dtype)
    decode = _ref_fn(ref_step.make_decode_step(ref_cfg, ctx, jit=False),
                     ref_cfg.dtype)
    B, S = prompt.shape
    logits, cache = prefill(ref, {"tokens": jnp.asarray(prompt)})
    cache = jax.tree.map(
        lambda dst, src: jax.lax.dynamic_update_slice(
            dst, src.astype(dst.dtype), (0,) * src.ndim),
        RM.init_cache(ref_cfg, B, max_len), cache)
    toks, margins, tols = [], [], []
    for i in range(max_new):
        if i:
            logits, cache = decode(ref, {"tokens": toks[-1]}, cache,
                                   jnp.int32(S + i - 1))
        top2 = np.sort(np.asarray(logits[:, -1], np.float32), axis=-1)
        margins.append(top2[:, -1] - top2[:, -2])
        tols.append(_logit_tol(ref_cfg.dtype, logits))
        toks.append(ref_step.sample(logits, None))
    return (np.asarray(jnp.concatenate(toks, axis=1)),
            np.stack(margins, 1), tols)


def _ref_prefill(ref_cfg):
    ctx = single_device_ctx()
    return _ref_fn(lambda p, b: RM.apply_prefill(p, ref_cfg, ctx, b),
                   ref_cfg.dtype)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_equal_the_reference_field_for_field(arch):
    for mine, ref in ((registry.get_config(arch),
                       ref_registry.get_config(arch)),
                      (registry.get_smoke_config(arch),
                       ref_registry.get_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert (mine.q_dim, mine.kv_dim) == (ref.q_dim, ref.kv_dim)
    full = registry.get_config(arch)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size, full.n_experts,
            full.top_k) == FULL_SHAPES[arch]
    assert full.head_dim in fa.WGMMA_HEAD_DIMS
    assert fa.design(torch.bfloat16, full.head_dim) == "wgmma"
    assert fa.design(torch.float32, full.head_dim) == "simt"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_qkv_with_qk_norm(dtype):
    """q and k RMS-normalised per head with their own f32 scales, after
    the reshape; v untouched."""
    ref_cfg, cfg = _arch_cfgs("qwen3-4b", dtype)
    rng = np.random.default_rng(8)
    p, tp = {}, {}
    for name, shape in (("wq", (64, cfg.q_dim)), ("wk", (64, cfg.kv_dim)),
                        ("wv", (64, cfg.kv_dim))):
        p[name], tp[name] = _pair(rng, shape, dtype, 0.125)
    for name in ("q_norm", "k_norm"):
        p[name], tp[name] = _pair(rng, (cfg.head_dim,))  # f32 scales
    x, tx = _pair(rng, (2, 7, 64), dtype)
    got, want = TL.attn_qkv(tp, tx, cfg), RL.attn_qkv(p, x, ref_cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == DTYPES[dtype][1]
        _close(g, w, F32_TOL if dtype == "float32" else 0.0)
    plain = TL.attn_qkv({k: v for k, v in tp.items() if "norm" not in k},
                        tx, cfg)
    _close(got[2], plain[2], 0.0)
    assert not torch.equal(got[0], plain[0])


def _ref_layers(ref):
    """The reference's stacked layers in order, (stack, index, FFN group):
    ``dense_blocks`` then ``moe_blocks``, or ``blocks``."""
    return [(ref[name], i, "moe" if "moe" in ref[name] else "mlp")
            for name in ("dense_blocks", "moe_blocks", "blocks")
            if name in ref for i in range(ref[name]["ln1"].shape[0])]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_archs_carry_and_init_match_the_reference_tree(arch):
    ref, params = _arch_params(arch, "bfloat16")
    ref_cfg, cfg = _arch_cfgs(arch, "bfloat16")
    layers = _ref_layers(ref)
    assert len(params["blocks"]) == len(layers) == cfg.n_layers
    for pb, (stack, i, group) in zip(params["blocks"], layers):
        assert group in pb and len(pb) == 4
        for g in ("attn", group):
            for name, t in _flat(pb[g]):
                want = stack[g]
                for key in name.split("."):
                    want = want[key]
                want = np.asarray(want[i])
                assert tuple(t.shape) == want.shape, name
                np.testing.assert_array_equal(_np(t), want.astype(np.float32))
                assert t.dtype == (torch.float32 if want.dtype == np.float32
                                   else torch.bfloat16), name
        if cfg.qk_norm:
            assert pb["attn"]["q_norm"].dtype == torch.float32
            assert tuple(pb["attn"]["k_norm"].shape) == (cfg.head_dim,)
        if group == "moe":
            assert pb["moe"]["router"].dtype == torch.float32
            assert tuple(pb["moe"]["w_down"].shape) == (
                cfg.n_experts, cfg.d_ff, cfg.d_model)
    mine = TM.init(cfg, seed=0, device="cpu")
    leaves = lambda p: [sorted(
        (g, k, tuple(t.shape), str(t.dtype)) for g in b if g != "ln1"
        and g != "ln2" for k, t in _flat(b[g])) for b in p["blocks"]]
    assert leaves(mine) == leaves(params)
    assert sorted(mine["embed"]) == sorted(params["embed"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_archs_prefill_and_decode_match_the_reference(arch, dtype):
    ref_cfg, cfg = _arch_cfgs(arch, dtype)
    ref, params = _arch_params(arch, dtype)
    ctx = single_device_ctx()
    tokens = _prompt()
    B, S = tokens.shape
    want, want_aux, ref_kv = _ref_prefill(ref_cfg)(
        ref, {"tokens": jnp.asarray(tokens)})
    got, aux, kv = TM.apply_prefill(params, cfg,
                                    {"tokens": torch.from_numpy(tokens)})
    assert tuple(got.shape) == (B, S, 256)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=F32_TOL,
                               atol=F32_TOL)
    if not cfg.n_experts:
        assert float(aux) == 0.0
    tol = _logit_tol(dtype, want)
    _close(got, want, tol)
    # k after qk-norm has unit RMS a head, entries up to ~4: the same rule
    _close(kv["k"], ref_kv["k"], _logit_tol(dtype, ref_kv["k"]))

    max_len = S + 3
    ref_cache = jax.tree.map(
        lambda dst, src: jax.lax.dynamic_update_slice(
            dst, src.astype(dst.dtype), (0,) * src.ndim),
        RM.init_cache(ref_cfg, B, max_len), ref_kv)
    cache = TM.init_cache(cfg, B, max_len, device="cpu")
    cache["k"][:, :, :S] = kv["k"]
    cache["v"][:, :, :S] = kv["v"]
    ref_decode = _ref_fn(lambda p, b, c, i: RM.apply_decode(
        p, ref_cfg, ctx, b, c, i), dtype)
    for i in range(3):
        step_tok = _prompt(B, 1, seed=10 + i)
        want, _, ref_cache = ref_decode(
            ref, {"tokens": jnp.asarray(step_tok)}, ref_cache,
            jnp.int32(S + i))
        got, _, cache = TM.apply_decode(
            params, cfg, {"tokens": torch.from_numpy(step_tok)}, cache, S + i)
        assert tuple(got.shape) == (B, 1, 256)
        _close(got, want, _logit_tol(dtype, want))
    assert not cache["k"][:, :, S + 3:].any()


def _first_part(want, got):
    """The first (step, row) where two greedy streams differ, or None."""
    diff = np.argwhere(want != got)
    if diff.size == 0:
        return None
    b, t = diff[np.lexsort((diff[:, 0], diff[:, 1]))][0]
    return int(t), int(b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_archs_generate_matches_the_reference_greedy_tokens(arch, dtype):
    """Greedy tokens equal to the reference's (f32), or in bf16 apart
    from the first step where the reference's own top-2 margin there is
    below the logits' tolerance: the margin of the step it ran, a decode
    step whose MoE capacity (cap_exp 1 at two tokens) differs from a
    prefill's over the same tokens."""
    ref_cfg, cfg = _arch_cfgs(arch, dtype)
    ref, params = _arch_params(arch, dtype)
    prompt = _prompt()
    max_new = 6
    max_len = prompt.shape[1] + max_new
    want, margins, tols = _ref_generate(ref, ref_cfg, prompt, max_new,
                                        max_len)
    before = fa.flash_attention_gqa.launches
    got = step.generate(params, cfg, prompt, max_new=max_new,
                        max_len=max_len, device="cpu")
    assert fa.flash_attention_gqa.launches == before   # plain on the CPU
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    part = _first_part(want, got.numpy())
    if part:
        t, b = part
        assert margins[b, t] < tols[t], (b, t, margins[b, t])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_launcher_serves_the_new_archs_on_the_cpu(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "12",
            "--max-new", "4", "--device", "cpu"]
    run = launcher.main(argv)
    assert tuple(run.tokens.shape) == (2, 4)
    assert int(run.tokens.min()) >= 0 and int(run.tokens.max()) < 256
    assert f"{arch}-smoke on cpu" in capsys.readouterr().out
    torch.testing.assert_close(launcher.main(argv).tokens, run.tokens,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# gemma3 (sliding window, 5:1 local:global, hd 256) and kimi-k2 (a leading
# dense layer before the MoE layers, a shared expert)
# ---------------------------------------------------------------------------
def test_window_schedule_is_the_references():
    for arch in ("gemma3-4b", "qwen3-4b"):
        for cfg, ref_cfg in ((registry.get_config(arch),
                              ref_registry.get_config(arch)),
                             (registry.get_smoke_config(arch),
                              ref_registry.get_smoke_config(arch))):
            want = np.asarray(RT.window_schedule(ref_cfg, cfg.n_layers))
            assert TT.window_schedule(cfg, cfg.n_layers) == want.tolist()
    full = TT.window_schedule(registry.get_config("gemma3-4b"), 34)
    assert full.count(1024) == 29 and full.count(0) == 5
    assert [i for i, w in enumerate(full) if w == 0] == [5, 11, 17, 23, 29]
    smoke = registry.get_smoke_config("gemma3-4b")
    assert TT.window_schedule(smoke, 3) == [16, 16, 0]
    only = dataclasses.replace(smoke, local_global_ratio=0)
    assert TT.window_schedule(only, 3) == [16, 16, 16]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 1, 5, 16])
def test_decode_attention_with_a_window(dtype, window):
    """Only the last ``window`` cache positions up to cur_index count
    (the reference's ``(cur_index - pos) < w``)."""
    rng = np.random.default_rng(window)
    q, tq = _pair(rng, (2, 1, 4, 16), dtype)
    k, tk = _pair(rng, (2, 24, 2, 16), dtype)
    v, tv = _pair(rng, (2, 24, 2, 16), dtype)
    for cur in (3, 20):
        got = TL.decode_attention(tq, tk, tv, cur, window=window)
        want = RL.decode_attention(q, k, v, jnp.int32(cur), window=window)
        _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)
    if window == 1:               # only position cur_index is valid
        got = TL.decode_attention(tq, tk, tv, 20, window=1)
        _close(got[:, 0].reshape(2, 2, 2, 16)[:, :, 0], tv[:, 20], 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma3_prefill_and_decode_past_the_window(dtype):
    """The smoke gemma3 (3 layers: two local of window 16, one global;
    hd 16) at S 48, three windows long: prefill logits and k, and five
    decode steps at positions 48-52, against the reference."""
    ref_cfg, cfg = _arch_cfgs("gemma3-4b", dtype)
    assert (cfg.sliding_window, cfg.local_global_ratio) == (16, 2)
    ref, params = _arch_params("gemma3-4b", dtype)
    ctx = single_device_ctx()
    tokens = _prompt(S=48, seed=3)
    B, S = tokens.shape
    want, _, ref_kv = _ref_prefill(ref_cfg)(ref,
                                            {"tokens": jnp.asarray(tokens)})
    got, aux, kv = TM.apply_prefill(params, cfg,
                                    {"tokens": torch.from_numpy(tokens)})
    assert float(aux) == 0.0
    _close(got, want, _logit_tol(dtype, want))
    _close(kv["k"], ref_kv["k"], _logit_tol(dtype, ref_kv["k"]))
    # the window matters here: global attention in every layer differs
    glob, _, _ = TM.apply_prefill(
        params, dataclasses.replace(cfg, sliding_window=0),
        {"tokens": torch.from_numpy(tokens)})
    assert float((glob.float() - got.float()).abs().max()) > \
        10 * _logit_tol(dtype, want)

    n_steps = 5
    ref_cache = jax.tree.map(
        lambda dst, src: jax.lax.dynamic_update_slice(
            dst, src.astype(dst.dtype), (0,) * src.ndim),
        RM.init_cache(ref_cfg, B, S + n_steps), ref_kv)
    cache = TM.init_cache(cfg, B, S + n_steps, device="cpu")
    assert tuple(cache["k"].shape) == (3, B, S + n_steps, 2, 16)
    cache["k"][:, :, :S] = kv["k"]
    cache["v"][:, :, :S] = kv["v"]
    ref_decode = _ref_fn(lambda p, b, c, i: RM.apply_decode(
        p, ref_cfg, ctx, b, c, i), dtype)
    for i in range(n_steps):
        step_tok = _prompt(B, 1, seed=20 + i)
        want, _, ref_cache = ref_decode(
            ref, {"tokens": jnp.asarray(step_tok)}, ref_cache,
            jnp.int32(S + i))
        got, _, cache = TM.apply_decode(
            params, cfg, {"tokens": torch.from_numpy(step_tok)}, cache, S + i)
        _close(got, want, _logit_tol(dtype, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma3_greedy_tokens_past_the_window(dtype):
    """``step.generate`` on the smoke gemma3 from a 48-token prompt, 8
    greedy tokens: equal to the reference's (f32), or apart only where
    the reference's top-2 margin is below the logits' tolerance."""
    ref_cfg, cfg = _arch_cfgs("gemma3-4b", dtype)
    ref, params = _arch_params("gemma3-4b", dtype)
    prompt = _prompt(S=48, seed=4)
    max_new = 8
    max_len = prompt.shape[1] + max_new
    want, margins, tols = _ref_generate(ref, ref_cfg, prompt, max_new,
                                        max_len)
    got = step.generate(params, cfg, prompt, max_new=max_new,
                        max_len=max_len, device="cpu").numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    part = _first_part(want, got)
    if part:
        t, b = part
        assert margins[b, t] < tols[t], (b, t, margins[b, t])


def test_kimi_k2_carries_its_dense_lead_ahead_of_the_moe_layers():
    """kimi-k2's smoke config: layer 0 is the reference's ``dense_blocks``
    (an FFN of width d_ff_dense), layer 1 its ``moe_blocks`` (experts
    and a shared expert of n_shared_experts · d_ff), in that order, bit
    for bit; the port's own init builds the same layers."""
    ref, params = _arch_params("kimi-k2-1t-a32b", "bfloat16")
    _, cfg = _arch_cfgs("kimi-k2-1t-a32b", "bfloat16")
    assert TT.layer_kinds(cfg) == ["dense_lead", "moe"]
    lead, moe_layer = params["blocks"]
    assert "moe" not in lead and "mlp" not in moe_layer
    assert tuple(lead["mlp"]["w_gate"].shape) == (cfg.d_model, cfg.d_ff_dense)
    np.testing.assert_array_equal(
        _np(lead["mlp"]["w_down"]),
        np.asarray(ref["dense_blocks"]["mlp"]["w_down"][0], np.float32))
    np.testing.assert_array_equal(
        _np(moe_layer["attn"]["wq"]),
        np.asarray(ref["moe_blocks"]["attn"]["wq"][0], np.float32))
    shared = moe_layer["moe"]["shared"]
    assert tuple(shared["w_up"].shape) == (cfg.d_model,
                                           cfg.n_shared_experts * cfg.d_ff)
    mine = TM.init(cfg, seed=0, device="cpu")
    assert [sorted(b) for b in mine["blocks"]] == \
        [sorted(b) for b in params["blocks"]]
    assert tuple(mine["blocks"][0]["mlp"]["w_up"].shape) == (
        cfg.d_model, cfg.d_ff_dense)
    with pytest.raises(ValueError, match="1 stacked layers"):
        lm_params_from_reference(
            {k: v for k, v in jax.tree.map(np.asarray, ref).items()
             if k != "dense_blocks"}, cfg, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kimi_k2_aux_and_routing_match_the_reference(dtype):
    """The load-balancing aux of kimi-k2's prefill sums its MoE layer
    alone (the dense lead adds nothing), equal to the reference's; a
    prefill records one MoE call, not one a layer."""
    from repro_torch.models import moe
    ref_cfg, cfg = _arch_cfgs("kimi-k2-1t-a32b", dtype)
    ref, params = _arch_params("kimi-k2-1t-a32b", dtype)
    tokens = _prompt(S=40, seed=5)
    _, want_aux, _ = _ref_prefill(ref_cfg)(ref,
                                           {"tokens": jnp.asarray(tokens)})
    moe.moe_apply.record = []
    try:
        _, aux, _ = TM.apply_prefill(params, cfg,
                                     {"tokens": torch.from_numpy(tokens)})
        records = moe.moe_apply.record
    finally:
        moe.moe_apply.record = None
    assert len(records) == cfg.n_layers - cfg.first_k_dense == 1
    assert float(aux) > 0
    # bf16: hidden states an ulp apart (attention summed in another
    # order) move the router's probabilities by ~2^-9 on the tokens they
    # touch, and aux is their mean (measured 3.5e-5 apart); one flipped
    # choice would move it by ~1 / (T·k) = 6e-3
    tol = F32_TOL if dtype == "float32" else 1e-3
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=tol,
                               atol=tol)


def test_logit_softcap_is_still_refused():
    cfg = dataclasses.replace(registry.get_smoke_config("gemma3-4b"),
                              attn_logit_softcap=50.0)
    with pytest.raises(NotImplementedError, match="logit softcap"):
        TM.init(cfg, device="cpu")
