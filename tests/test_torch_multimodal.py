"""The port's two multimodal archs against the JAX package: musicgen-medium
(frame embeddings in, a two-matrix GELU FFN) and llama-3.2-vision-90b
(superblocks of self-attention layers and a cross-attention layer onto
image tokens, through kernel B4 at keys of their own length).

Params come from ``repro.models.model.init(PRNGKey(0), cfg)`` and are
carried into the port with ``repro_torch.carry.lm_params_from_reference``;
inputs are made with numpy from a seed and handed to both. The port runs
on the CPU, where B4 is its plain version; the reference runs as
``tests/test_torch_lm.py`` runs it, jitted and in bf16 compiled with
``xla_allow_excess_precision`` off.

Tolerances, each with its reason:

  - float32, 1e-5 (rtol and atol): the two sum the same products in
    other orders (matmuls, attention tiles of 64 keys against the
    reference's 16-512).
  - bfloat16 logits, ``test_torch_lm``'s rule: 3e-2 · max(1, max |logit|)
    (one bf16 ulp at |logit| 2-4 is 2^-6 to 2^-5; attention outputs an ulp
    apart move every later rounding). Greedy tokens are equal, or part
    first at a step where the reference's own top-2 margin is below that
    limit.
  - ``gelu``: bit for bit in bf16. In f32 within 1e-6 (rtol and atol):
    XLA's CPU tanh is a rational approximation and torch's is libm's, an
    f32 ulp or so apart; ``1 + tanh`` then keeps that ulp of 1 where the
    output is small, and the 1e-6 atol covers it there.
  - Projections, norms and the FFN's matmuls: bit for bit in bf16.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.distributed.meshctx import single_device_ctx
from repro.launch import serve as ref_launcher
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import transformer as RT
from repro.serve import step as ref_step
from repro_torch.carry import lm_params_from_reference
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as launcher
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serve import step

torch.set_num_threads(2)
F32_TOL = 1e-5
BF16_TOL = 3e-2
GELU_F32_TOL = 1e-6
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}
AUDIO, VLM = "musicgen-medium", "llama-3.2-vision-90b"
ARCHS = [AUDIO, VLM]
FULL_SHAPES = {  # (n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff,
    #              vocab, cross_attn_every, n_image_tokens)
    AUDIO: (48, 1536, 24, 24, 64, 6144, 2048, 0, 0),
    VLM: (80, 8192, 64, 8, 128, 28_672, 128_256, 4, 1600)}


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


def _cfgs(arch, dtype):
    return (dataclasses.replace(ref_registry.get_smoke_config(arch),
                                dtype=dtype),
            dataclasses.replace(registry.get_smoke_config(arch), dtype=dtype))


def _params(arch, dtype, seed=0):
    ref_cfg, cfg = _cfgs(arch, dtype)
    ref = RM.init(jax.random.PRNGKey(seed), ref_cfg)
    return ref, lm_params_from_reference(jax.tree.map(np.asarray, ref), cfg,
                                         "cpu")


def _logit_tol(dtype, want):
    if dtype == "float32":
        return F32_TOL
    return BF16_TOL * max(1.0, float(np.abs(_np(want)).max()))


def _ref_fn(fn, dtype):
    """``fn`` jitted; in bf16 compiled with ``xla_allow_excess_precision``
    off, so a fused chain of bf16 operations rounds at each one, as the
    port does (``tests/test_torch_lm.py``)."""
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


def _tokens(B=2, S=37, seed=0, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _image(cfg, dtype="float32", B=2, seed=9):
    """Seeded image embeddings, normal x 0.02 as tests/test_arch_smoke.py
    draws them: (reference array, port tensor)."""
    return _pair(np.random.default_rng(seed),
                 (B, cfg.n_image_tokens, cfg.d_model), dtype, 0.02)


def _ref_cache(ref_cfg, B, max_len, ref_kv):
    """The reference's decode cache after a prefill, as its ``generate``
    builds it: each prefill entry written into ``init_cache``'s, or taken
    as it is where the shapes agree (the VLM's image k and v)."""
    return jax.tree.map(
        lambda dst, src: jax.lax.dynamic_update_slice(
            dst, src.astype(dst.dtype), (0,) * src.ndim)
        if dst.shape != src.shape else src,
        RM.init_cache(ref_cfg, B, max_len), ref_kv)


def _self_kv(ref_cfg, kv):
    """The reference's self-attention k or v as the port stacks them:
    the VLM's [n_sb, per, B, S, KV, hd] flattened to one a layer."""
    kv = np.asarray(kv, np.float32)
    return kv.reshape((-1,) + kv.shape[2:]) if ref_cfg.family == "vlm" \
        else kv


# ---------------------------------------------------------------------------
# configs, registry, launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    for mine, ref in ((registry.get_config(arch),
                       ref_registry.get_config(arch)),
                      (registry.get_smoke_config(arch),
                       ref_registry.get_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert (mine.q_dim, mine.kv_dim) == (ref.q_dim, ref.kv_dim)
    full = registry.get_config(arch)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size, full.cross_attn_every,
            full.n_image_tokens) == FULL_SHAPES[arch]
    assert fa.design(torch.bfloat16, full.head_dim) == "wgmma"
    assert fa.design(torch.float32, full.head_dim) == "simt"
    TT.check_supported(full)


def test_registry_serves_the_references_ten_archs():
    assert sorted(registry.ARCH_NAMES) == sorted(ref_registry.ARCH_NAMES)
    assert len(registry.ARCH_NAMES) == 10


@pytest.mark.parametrize("arch,message", [
    (AUDIO, "takes frame embeddings"), (VLM, "C21")])
def test_launcher_refuses_both_archs_before_any_work(arch, message,
                                                     monkeypatch):
    """The port's launcher refuses musicgen with the reference launcher's
    own message, and the VLM naming ROADMAP C21 and
    ``generate(image_embeds=...)``, before it draws a weight."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu"]
    monkeypatch.setattr(TM, "init", lambda *a, **k: pytest.fail("init ran"))
    with pytest.raises(SystemExit, match=message) as mine:
        launcher.main(argv)
    if arch == VLM:
        assert "generate(image_embeds=...)" in str(mine.value)
        return
    monkeypatch.setattr(sys, "argv", ["serve"] + argv[:3])
    with pytest.raises(SystemExit) as ref:
        ref_launcher.main()
    assert str(mine.value) == str(ref.value)


# ---------------------------------------------------------------------------
# layers: gelu, the GELU FFN, cross-attention projections, B4 at Sk != S
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gelu_is_jax_nn_gelu(dtype):
    """2^16 normal x 3 inputs through ``jax.nn.gelu`` (its default tanh
    form) and the port's ``gelu``: bf16 bit for bit (the fused
    ``F.gelu(approximate="tanh")`` is not), f32 within GELU_F32_TOL."""
    x, tx = _pair(np.random.default_rng(0), (1 << 16,), dtype, 3.0)
    want = _ref_fn(jax.nn.gelu, dtype)(x)
    got = TL.gelu(tx)
    assert got.dtype == DTYPES[dtype][1]
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), _np(want))
        fused = torch.nn.functional.gelu(tx, approximate="tanh")
        assert (_np(fused) != _np(want)).sum() > 1000
    else:
        _close(got, want, GELU_F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_apply_gelu(dtype):
    rng = np.random.default_rng(4)
    p, tp = {}, {}
    for name, shape in (("w_up", (64, 128)), ("w_down", (128, 64))):
        p[name], tp[name] = _pair(rng, shape, dtype, 0.125)
    x, tx = _pair(rng, (2, 7, 64), dtype)
    want = _ref_fn(RL.ffn_apply, dtype)(p, x)
    _close(TL.ffn_apply(tp, tx), want,
           F32_TOL if dtype == "float32" else 0.0)


def test_gelu_ffn_init_has_two_matrices_in_the_references_statistics():
    _, cfg = _cfgs(AUDIO, "bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = TL.ffn_init(gen, cfg)
    assert sorted(p) == ["w_down", "w_up"]
    assert tuple(p["w_up"].shape) == (cfg.d_model, cfg.d_ff)
    assert tuple(p["w_down"].shape) == (cfg.d_ff, cfg.d_model)
    down = 1.0 / np.sqrt(cfg.d_ff) / np.sqrt(2 * cfg.n_layers)
    assert float(p["w_down"].float().abs().max()) <= 3 * down * (1 + 2 ** -7)
    swiglu = TL.ffn_init(gen, dataclasses.replace(cfg, ffn_kind="swiglu"))
    assert sorted(swiglu) == ["w_down", "w_gate", "w_up"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_qkv_with_kv_x(dtype):
    """q from x, k and v from ``kv_x`` of another length (the image
    tokens): shapes and values the reference's."""
    ref_cfg, cfg = _cfgs(VLM, dtype)
    rng = np.random.default_rng(3)
    p, tp = {}, {}
    for name, shape in (("wq", (64, cfg.q_dim)), ("wk", (64, cfg.kv_dim)),
                        ("wv", (64, cfg.kv_dim))):
        p[name], tp[name] = _pair(rng, shape, dtype, 0.125)
    x, tx = _pair(rng, (2, 7, 64), dtype)
    img, timg = _pair(rng, (2, 16, 64), dtype)
    got = TL.attn_qkv(tp, tx, cfg, kv_x=timg)
    want = RL.attn_qkv(p, x, ref_cfg, kv_x=img)
    assert [tuple(g.shape) for g in got] == [(2, 7, 4, 16), (2, 16, 2, 16),
                                             (2, 16, 2, 16)]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, F32_TOL if dtype == "float32" else 0.0)
    _close(got[0], TL.attn_qkv(tp, tx, cfg)[0], 0.0)


def test_cross_attention_params_have_no_qkv_bias():
    cfg = dataclasses.replace(registry.get_smoke_config(VLM), qkv_bias=True)
    gen = torch.Generator().manual_seed(0)
    assert "bq" in TL.attn_init(gen, cfg)
    cross = TL.attn_init(gen, cfg, cross=True)
    assert sorted(cross) == ["wk", "wo", "wq", "wv"]
    ref = RL.attn_init(jax.random.PRNGKey(0),
                       dataclasses.replace(ref_registry.get_smoke_config(VLM),
                                           qkv_bias=True), 1, cross=True)
    assert sorted(ref) == sorted(cross)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,Sk,H,KV", [(37, 16, 4, 2), (37, 100, 4, 2),
                                       (1, 16, 4, 2), (1, 100, 8, 1),
                                       (70, 130, 4, 4)])
def test_plain_cross_attention_matches_blockwise_attention(S, Sk, H, KV,
                                                           dtype):
    """``flash_attention_gqa_plain`` (and the wrapper, which runs it on the
    CPU) at Sk != S, non-causal, against the reference's
    ``blockwise_attention`` as its cross layer calls it: keys that fill
    part of a 64-key tile (16), that no tile divides (100, 130), one
    query (decode), grouped heads."""
    rng = np.random.default_rng(S * Sk + H)
    q, tq = _pair(rng, (2, S, H, 16), dtype)
    k, tk = _pair(rng, (2, Sk, KV, 16), dtype)
    v, tv = _pair(rng, (2, Sk, KV, 16), dtype)
    want = RL.blockwise_attention(q, k, v, causal=False, window=0,
                                  block_q=min(256, S), block_kv=min(512, Sk))
    plain = fa.flash_attention_gqa_plain(tq, tk, tv, causal=False)
    assert plain.shape == tq.shape and plain.dtype == tq.dtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(plain, want, tol)
    before = fa.flash_attention_gqa.launches
    got = TL.blockwise_attention(tq, tk, tv, causal=False)
    assert fa.flash_attention_gqa.launches == before
    _close(got, plain, 0.0)


def test_b4_refuses_causal_windowed_or_mixed_cross_attention():
    rng = np.random.default_rng(0)
    _, q = _pair(rng, (1, 8, 2, 16))
    _, k = _pair(rng, (1, 12, 1, 16))
    for kw in ({}, {"causal": True}, {"causal": False, "window": 4},
               {"causal": True, "window": 4}):
        with pytest.raises(ValueError, match="non-causal with no window"):
            fa.flash_attention_gqa(q, k, k, **kw)
    with pytest.raises(ValueError, match="at least one key"):
        fa.flash_attention_gqa(q, k[:, :0], k[:, :0], causal=False)
    with pytest.raises(TypeError, match="share"):
        fa.flash_attention_gqa(q.bfloat16(), k, k, causal=False)
    with pytest.raises(ValueError, match=r"\[B, Sk, KV, hd\]"):
        fa.flash_attention_gqa(q, k, k[:, :5], causal=False)
    # self-attention keeps its masks
    out = fa.flash_attention_gqa(q, k[:, :8], k[:, :8], window=4)
    assert out.shape == q.shape


# ---------------------------------------------------------------------------
# the VLM's pieces: image k and v, the cross layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("img_dtype", ["float32", "bfloat16"])
def test_image_kv_promotes_as_the_reference(img_dtype):
    """Each cross layer's k and v from the image embeddings in the bf16
    model: f32 embeddings give f32 k and v (the reference's jnp ``@``
    promotes), bf16 ones bf16, with no RoPE; stacked one a cross layer."""
    ref_cfg, cfg = _cfgs(VLM, "bfloat16")
    ref, params = _params(VLM, "bfloat16")
    img, timg = _image(cfg, img_dtype)
    want_k, want_v = _ref_fn(lambda pb, x: RT._image_kv(pb, x, ref_cfg),
                             "bfloat16")(ref["cross_blocks"], img)
    got_k, got_v = TT._image_kv(params["cross_blocks"], timg, cfg)
    n_sb = cfg.n_layers // cfg.cross_attn_every
    assert tuple(got_k.shape) == want_k.shape == (
        n_sb, 2, cfg.n_image_tokens, cfg.n_kv_heads, cfg.head_dim)
    assert got_k.dtype == got_v.dtype == DTYPES[img_dtype][1]
    assert want_k.dtype == DTYPES[img_dtype][0]
    tol = F32_TOL if img_dtype == "float32" else 0.0
    _close(got_k, want_k, tol)
    _close(got_v, want_v, tol)


@pytest.mark.parametrize("img_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 37])
def test_cross_layer_matches_the_reference(S, img_dtype):
    """One cross layer of the bf16 model (ln1, q, non-causal attention over
    the image's k and v, wo, its FFN) at prefill (S 37) and decode (S 1):
    with f32 image k and v the port upcasts q, which is exact, and casts
    the output back to bf16, as the reference's promotion does."""
    ref_cfg, cfg = _cfgs(VLM, "bfloat16")
    ref, params = _params(VLM, "bfloat16")
    img, timg = _image(cfg, img_dtype)
    ik, iv = TT._image_kv(params["cross_blocks"], timg, cfg)
    rik, riv = RT._image_kv(ref["cross_blocks"], img, ref_cfg)
    x, tx = _pair(np.random.default_rng(5), (2, S, cfg.d_model), "bfloat16")
    pb = jax.tree.map(lambda t: t[1], ref["cross_blocks"])
    want = _ref_fn(lambda p, x, k, v: RT._cross_attn(p, x, (k, v), ref_cfg),
                   "bfloat16")(pb, x, rik[1], riv[1])
    got = TT._cross_attn(params["cross_blocks"][1], tx, (ik[1], iv[1]), cfg)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _close(got, want, _logit_tol("bfloat16", want))


# ---------------------------------------------------------------------------
# carry and init
# ---------------------------------------------------------------------------
def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _leaves(layers):
    return [sorted((name, tuple(t.shape), str(t.dtype))
                   for name, t in _flat(b)) for b in layers]


@pytest.mark.parametrize("arch", ARCHS)
def test_carry_keeps_every_layer_bit_for_bit(arch):
    """The reference's stacks unstacked one dict a layer: ``blocks``
    (musicgen) or ``self_blocks`` as ``"blocks"``, and the VLM's
    ``cross_blocks`` as ``"cross_blocks"``, each array's dtype and bits;
    the port's own init builds the same tree."""
    ref, params = _params(arch, "bfloat16")
    _, cfg = _cfgs(arch, "bfloat16")
    stacks = [("blocks", "self_blocks" if arch == VLM else "blocks")]
    if arch == VLM:
        stacks.append(("cross_blocks", "cross_blocks"))
    n_sb = cfg.n_layers // max(cfg.cross_attn_every, 1)
    for mine, theirs in stacks:
        want_n = n_sb if mine == "cross_blocks" else cfg.n_layers
        assert len(params[mine]) == want_n
        for i, pb in enumerate(params[mine]):
            for name, t in _flat(pb):
                want = ref[theirs]
                for key in name.split("."):
                    want = want[key]
                want = np.asarray(want[i])
                assert tuple(t.shape) == want.shape, name
                assert t.dtype == (torch.float32 if want.dtype == np.float32
                                   else torch.bfloat16), name
                np.testing.assert_array_equal(_np(t), want.astype(np.float32))
    if arch == AUDIO:
        assert sorted(params["blocks"][0]["mlp"]) == ["w_down", "w_up"]
    else:
        assert sorted(params["cross_blocks"][0]["attn"]) == [
            "wk", "wo", "wq", "wv"]
    mine = TM.init(cfg, seed=0, device="cpu")
    for key, _ in stacks:
        assert _leaves(mine[key]) == _leaves(params[key])
    assert sorted(mine) == sorted(params)
    assert sorted(mine["embed"]) == sorted(params["embed"])


def test_carry_checks_the_vlms_layer_counts():
    ref, _ = _params(VLM, "bfloat16")
    _, cfg = _cfgs(VLM, "bfloat16")
    tree = jax.tree.map(np.asarray, ref)
    short = dict(tree, cross_blocks=jax.tree.map(lambda t: t[:1],
                                                 tree["cross_blocks"]))
    with pytest.raises(ValueError, match="1 stacked layers in cross_blocks,"):
        lm_params_from_reference(short, cfg, "cpu")
    short = dict(tree, self_blocks=jax.tree.map(lambda t: t[:3],
                                                tree["self_blocks"]))
    with pytest.raises(ValueError, match="3 stacked layers in self_blocks,"):
        lm_params_from_reference(short, cfg, "cpu")


def test_vlm_init_draws_the_references_statistics():
    """The port's VLM at the full config's depth (80 self layers in 20
    superblocks of 4) in the smoke widths: wo of self and cross layers
    scaled by 1/sqrt(2 · 80), the projections N(0, 1/d_in) cut at ±3σ,
    the table N(0, 0.02²)."""
    cfg = dataclasses.replace(registry.get_smoke_config(VLM), n_layers=80,
                              cross_attn_every=4)
    params = TM.init(cfg, seed=0, device="cpu")
    assert len(params["blocks"]) == 80 and len(params["cross_blocks"]) == 20
    std = 1.0 / np.sqrt(cfg.d_model)
    for group in ("blocks", "cross_blocks"):
        wq = torch.stack([b["attn"]["wq"] for b in params[group]]).float()
        assert float(wq.abs().max()) <= 3.0 * std * (1 + 2 ** -7)
        assert abs(float(wq.std()) / std - 0.9866) < 0.05  # N(0,1) cut at ±3
        wo = torch.stack([b["attn"]["wo"] for b in params[group]]).float()
        wo_std = 1.0 / np.sqrt(cfg.q_dim) / np.sqrt(2 * 80)
        assert float(wo.abs().max()) <= 3.0 * wo_std * (1 + 2 ** -7)
        assert abs(float(wo.std()) / wo_std - 0.9866) < 0.05
    table = params["embed"]["table"].float()
    assert abs(float(table.std()) - 0.02) < 0.002
    assert torch.equal(TM.init(cfg, seed=0, device="cpu")["cross_blocks"][3][
        "mlp"]["w_up"], params["cross_blocks"][3]["mlp"]["w_up"])


# ---------------------------------------------------------------------------
# the slice as a whole: prefill and decode logits, greedy tokens, C21
# ---------------------------------------------------------------------------
def _batches(arch, cfg, dtype, inputs, B=2, S=37, n_steps=3):
    """(reference prefill batch, port prefill batch, [(reference step,
    port step)]) for musicgen on tokens or on frame embeddings, and the
    VLM on tokens beside f32 image embeddings."""
    rng = np.random.default_rng(1)
    if inputs == "embeds":
        e, te = _pair(rng, (B, S + n_steps, cfg.d_model), dtype)
        pre = ({"embeds": e[:, :S]}, {"embeds": te[:, :S]})
        steps = [({"embeds": e[:, S + i:S + i + 1]},
                  {"embeds": te[:, S + i:S + i + 1]}) for i in range(n_steps)]
        return pre[0], pre[1], steps
    toks = _tokens(B, S + n_steps, vocab=cfg.vocab_size)
    pre = ({"tokens": jnp.asarray(toks[:, :S])},
           {"tokens": torch.from_numpy(toks[:, :S])})
    if arch == VLM:
        img, timg = _image(cfg, "float32", B)
        pre[0]["image_embeds"], pre[1]["image_embeds"] = img, timg
    steps = [({"tokens": jnp.asarray(toks[:, S + i:S + i + 1])},
              {"tokens": torch.from_numpy(toks[:, S + i:S + i + 1])})
             for i in range(n_steps)]
    return pre[0], pre[1], steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,inputs", [(AUDIO, "tokens"),
                                         (AUDIO, "embeds"),
                                         (VLM, "tokens")])
def test_prefill_and_decode_logits_match_the_reference(arch, inputs, dtype):
    ref_cfg, cfg = _cfgs(arch, dtype)
    ref, params = _params(arch, dtype)
    ctx = single_device_ctx()
    ref_pre, pre, steps = _batches(arch, cfg, dtype, inputs)
    B, S = 2, 37
    want, _, ref_kv = _ref_fn(lambda p, b: RM.apply_prefill(
        p, ref_cfg, ctx, b), dtype)(ref, ref_pre)
    before = fa.flash_attention_gqa.launches
    got, aux, kv = TM.apply_prefill(params, cfg, pre)
    assert fa.flash_attention_gqa.launches == before   # plain on the CPU
    assert tuple(got.shape) == (B, S, cfg.vocab_size)
    assert float(aux) == 0.0
    _close(got, want, _logit_tol(dtype, want))
    _close(kv["k"], _self_kv(ref_cfg, ref_kv["k"]),
           _logit_tol(dtype, ref_kv["k"]))
    if arch == VLM:
        assert kv["img_k"].dtype == torch.float32     # f32 images
        _close(kv["img_v"], ref_kv["img_v"], F32_TOL)

    max_len = S + len(steps)
    ref_cache = _ref_cache(ref_cfg, B, max_len, ref_kv)
    cache = step.decode_cache(cfg, kv, B, S, max_len, "cpu")
    assert tuple(cache["k"].shape) == (cfg.n_layers, B, max_len,
                                       cfg.n_kv_heads, cfg.head_dim)
    ref_decode = _ref_fn(lambda p, b, c, i: RM.apply_decode(
        p, ref_cfg, ctx, b, c, i), dtype)
    for i, (ref_b, b) in enumerate(steps):
        want, _, ref_cache = ref_decode(ref, ref_b, ref_cache,
                                        jnp.int32(S + i))
        got, _, cache = TM.apply_decode(params, cfg, b, cache, S + i)
        assert tuple(got.shape) == (B, 1, cfg.vocab_size)
        _close(got, want, _logit_tol(dtype, want))
    _close(cache["k"], _self_kv(ref_cfg, ref_cache["k"]),
           _logit_tol(dtype, ref_cache["k"]))


def test_vlm_decode_cache_hands_the_prefills_image_kv_on():
    """``init_cache`` zeroes the image k and v at the reference's shape;
    ``decode_cache`` takes the prefill's own tensors in their place
    (allocating no second copy) and writes the self k and v into a
    cache of ``max_len`` positions."""
    ref_cfg, cfg = _cfgs(VLM, "float32")
    B, S, max_len = 2, 5, 9
    ref_cache = RM.init_cache(ref_cfg, B, max_len)
    zeroed = TM.init_cache(cfg, B, max_len, device="cpu")
    for name in ("img_k", "img_v"):
        assert tuple(zeroed[name].shape) == tuple(ref_cache[name].shape)
        assert not zeroed[name].any()
    rng = np.random.default_rng(3)
    kv = {name: torch.from_numpy(rng.standard_normal(
        tuple(zeroed[name].shape[:2]) + (S if name in ("k", "v") else
                                         cfg.n_image_tokens,)
        + tuple(zeroed[name].shape[3:])).astype(np.float32))
        for name in ("k", "v", "img_k", "img_v")}
    cache = step.decode_cache(cfg, kv, B, S, max_len, "cpu")
    assert cache["img_k"] is kv["img_k"] and cache["img_v"] is kv["img_v"]
    assert torch.equal(cache["k"][:, :, :S], kv["k"])
    assert not cache["v"][:, :, S:].any()


def test_musicgen_takes_embeddings_in_place_of_tokens():
    """With ``embeds`` in the batch the table is not read: the same
    logits with the table zeroed; the embeddings are cast to the
    config's dtype (f32 frames into the bf16 model)."""
    _, cfg = _cfgs(AUDIO, "bfloat16")
    _, params = _params(AUDIO, "bfloat16")
    e = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32))
    got, _, _ = TM.apply_prefill(params, cfg, {"embeds": e})
    zeroed = dict(params, embed=dict(params["embed"]))
    zeroed["embed"]["table"] = torch.zeros_like(params["embed"]["table"])
    again, _, _ = TM.apply_prefill(zeroed, cfg, {"embeds": e.bfloat16()})
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def _first_part(want, got):
    diff = np.argwhere(want != got)
    if diff.size == 0:
        return None
    b, t = diff[np.lexsort((diff[:, 0], diff[:, 1]))][0]
    return int(t), int(b)


def _margin_at(ref, ref_cfg, ref_pre, ref_tokens, part):
    """The reference's top-2 margin where two greedy streams first part,
    teacher-forced on its own tokens (the VLM's image embeddings go in
    beside them)."""
    t, b = part
    seq = np.concatenate([np.asarray(ref_pre["tokens"]), ref_tokens[:, :t]],
                         axis=1)
    batch = dict(ref_pre, tokens=jnp.asarray(seq))
    logits, _, _ = _ref_fn(lambda p, x: RM.apply_prefill(
        p, ref_cfg, single_device_ctx(), x), ref_cfg.dtype)(ref, batch)
    top2 = np.sort(np.asarray(logits[b, -1], np.float32))[-2:]
    return float(top2[1] - top2[0]), _logit_tol(ref_cfg.dtype, logits)


def _ref_vlm_generate(ref, ref_cfg, ref_pre, max_new, max_len):
    """The reference's greedy loop driven by hand through its
    ``make_prefill`` and ``make_decode_step``, the image embeddings in the
    prefill batch (its own ``generate`` cannot pass them: C21)."""
    ctx = single_device_ctx()
    prefill = _ref_fn(ref_step.make_prefill(ref_cfg, ctx, jit=False),
                      ref_cfg.dtype)
    decode = _ref_fn(ref_step.make_decode_step(ref_cfg, ctx, jit=False),
                     ref_cfg.dtype)
    B, S = ref_pre["tokens"].shape
    logits, cache = prefill(ref, ref_pre)
    cache = _ref_cache(ref_cfg, B, max_len, cache)
    toks = [ref_step.sample(logits, None)]
    for i in range(max_new - 1):
        logits, cache = decode(ref, {"tokens": toks[-1]}, cache,
                               jnp.int32(S + i))
        toks.append(ref_step.sample(logits, None))
    return np.asarray(jnp.concatenate(toks, axis=1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_the_reference_greedy_tokens(arch, dtype):
    """``step.generate`` against the reference's greedy tokens: musicgen
    through the reference's own ``generate``, the VLM through its prefill
    and decode steps with the image embeddings. f32 equal; bf16 equal up
    to a step where the reference's top-2 margin is below the logits'
    limit."""
    ref_cfg, cfg = _cfgs(arch, dtype)
    ref, params = _params(arch, dtype)
    ref_pre, pre, _ = _batches(arch, cfg, dtype, "tokens")
    max_new = 6
    max_len = 37 + max_new
    if arch == AUDIO:
        want = np.asarray(ref_step.generate(
            ref, ref_cfg, single_device_ctx(), ref_pre["tokens"],
            max_new=max_new, max_len=max_len))
    else:
        want = _ref_vlm_generate(ref, ref_cfg, ref_pre, max_new, max_len)
    got = step.generate(params, cfg, pre["tokens"], max_new=max_new,
                        max_len=max_len, device="cpu",
                        image_embeds=pre.get("image_embeds"))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    part = _first_part(want, got.numpy())
    if part:
        margin, tol = _margin_at(ref, ref_cfg, ref_pre, want, part)
        assert margin < tol, (part, margin, tol)


def test_c21_the_references_generate_raises_and_the_ports_refuses():
    """ROADMAP C21: the reference's ``generate`` prefills on the tokens
    alone, so its VLM raises ``KeyError: 'image_embeds'``; the port's
    ``generate`` raises ``ValueError`` naming C21 before any work, and
    refuses image embeddings for a family that takes none."""
    ref_cfg, cfg = _cfgs(VLM, "float32")
    ref, params = _params(VLM, "float32")
    prompt = _tokens(vocab=cfg.vocab_size)
    with pytest.raises(KeyError, match="image_embeds"):
        ref_step.generate(ref, ref_cfg, single_device_ctx(),
                          jnp.asarray(prompt), max_new=2, max_len=39)
    before = fa.flash_attention_gqa.launches
    with pytest.raises(ValueError, match="C21"):
        step.generate(params, cfg, prompt, max_new=2, max_len=39,
                      device="cpu")
    _, acfg = _cfgs(AUDIO, "float32")
    _, aparams = _params(AUDIO, "float32")
    _, timg = _image(cfg)
    with pytest.raises(ValueError, match="C21"):
        step.generate(aparams, acfg, prompt, max_new=2, max_len=39,
                      device="cpu", image_embeds=timg)
    assert fa.flash_attention_gqa.launches == before
    out = step.generate(params, cfg, prompt, max_new=2, max_len=39,
                        device="cpu", image_embeds=timg)
    assert tuple(out.shape) == (2, 2)


def test_c21_the_references_launcher_crashes_mid_run(monkeypatch):
    """The reference's launcher serves the VLM into the same ``KeyError``
    (after drawing its weights); the port's refuses it up front
    (``test_launcher_refuses_both_archs_before_any_work``)."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", VLM, "--smoke",
                                      "--max-new", "2"])
    with pytest.raises(KeyError, match="image_embeds"):
        ref_launcher.main()
