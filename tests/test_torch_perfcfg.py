"""The perf flags on one device (``models/perfcfg``): the reference's own
tests of them (``tests/test_perf_variants.py``) run on the port at their
limits, and the port against the JAX package with the same flags set.

Both take the same weights: the reference's ``init`` carried into the
port's layout (``carry.lm_params_from_reference``). The reference's
limits, each kept: banded against base, 2e-2 (logits) and 5e-2
(gradients), rtol and atol; ``sp_residual`` against base, 2e-2; the
bf16 router against the f32 one, and ``a2a_int8`` against exact, a mean
|Δ| / mean |base| below 0.05 and 0.03. On the port ``banded_local``
changes no work (ROADMAP C29): B4's windowed instance already starts a
query tile's key loop at the band, so its output is the flag off's bit
for bit, which is held too, and so is ``sp_residual`` on one device,
where it has no mesh to lay out.

Port against reference, f32, 1e-5 (rtol and atol): the same products
summed in other orders, as ``tests/test_torch_lm.py`` holds the
one-device forward; ``a2a_int8`` too, its quantization being the
reference's bit for bit (``test_quantize_rows_is_the_references_
arithmetic``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.distributed.meshctx import single_device_ctx
from repro.models import model as RM
from repro.models import perfcfg as ref_perfcfg
from repro_torch import carry
from repro_torch.configs import registry
from repro_torch.models import model as M
from repro_torch.models import moe, perfcfg

torch.set_num_threads(2)
F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def _reset():
    perfcfg.reset()
    ref_perfcfg.reset()
    yield
    perfcfg.reset()
    ref_perfcfg.reset()


def _setup(arch, S, dtype=None):
    """(port cfg, port params, tokens [2, S], reference cfg and params):
    the reference's ``init`` from key 0 carried into the port."""
    fields = {} if dtype is None else {"dtype": dtype}
    rcfg = dataclasses.replace(ref_registry.get_smoke_config(arch), **fields)
    cfg = dataclasses.replace(registry.get_smoke_config(arch), **fields)
    rparams = RM.init(jax.random.PRNGKey(0), rcfg)
    params = carry.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), cfg, "cpu")
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, S), 0,
                                           cfg.vocab_size))
    return cfg, params, tokens, rcfg, rparams


def _logits(cfg, params, tokens):
    with torch.no_grad():
        return M.apply_train(params, cfg, {"tokens": torch.from_numpy(
            tokens)})[0].float().numpy()


def _ref_logits(rcfg, rparams, tokens):
    return np.asarray(jax.jit(lambda p, b: RM.apply_train(
        p, rcfg, single_device_ctx(), b)[0])(rparams, {
            "tokens": jnp.asarray(tokens)}), np.float32)


def _grads(cfg, params, tokens):
    leaves = [t.requires_grad_(True) for t in _flat(params)]
    loss, _ = M.loss_fn(params, cfg, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return [g.float().numpy() for g in grads]


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in tree for t in _flat(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _flat(v)]
    return [tree]


def _set(variant):
    perfcfg.set_variant(variant)
    ref_perfcfg.set_variant(variant)


# -- the reference's five tests, on the port -----------------------------
def test_banded_variant_matches_base_gemma3():
    cfg, params, tokens, rcfg, rparams = _setup("gemma3-4b", 32)
    base = _logits(cfg, params, tokens)
    _set("banded")
    opt = _logits(cfg, params, tokens)
    np.testing.assert_allclose(opt, base, rtol=2e-2, atol=2e-2)
    assert np.array_equal(opt, base)            # C29: no work changes
    np.testing.assert_allclose(opt, _ref_logits(rcfg, rparams, tokens),
                               rtol=2e-2, atol=2e-2)


def test_banded_variant_grads_match():
    cfg, params, tokens, _, _ = _setup("gemma3-4b", 32)
    base = _grads(cfg, params, tokens)
    _set("banded")
    opt = _grads(cfg, params, tokens)
    for a, b in zip(base, opt):
        np.testing.assert_allclose(a, b, rtol=5e-2, atol=5e-2)
        assert np.array_equal(a, b)


def test_sp_residual_matches_base_moe():
    cfg, params, tokens, _, _ = _setup("qwen3-moe-235b-a22b", 16)
    base = _logits(cfg, params, tokens)
    _set("spresid")
    opt = _logits(cfg, params, tokens)
    np.testing.assert_allclose(opt, base, rtol=2e-2, atol=2e-2)
    assert np.array_equal(opt, base)


def test_router_bf16_close_to_fp32():
    cfg, params, tokens, _, _ = _setup("qwen3-moe-235b-a22b", 16)
    opt = _logits(cfg, params, tokens)          # router_bf16 default on
    _set("paperfaithful")                       # fp32 router
    base = _logits(cfg, params, tokens)
    denom = np.abs(base).mean() + 1e-6
    assert np.abs(opt - base).mean() / denom < 0.05
    assert not np.array_equal(opt, base)        # the flag acts


def test_a2a_int8_close_to_exact():
    cfg, params, tokens, _, _ = _setup("kimi-k2-1t-a32b", 16)
    base = _logits(cfg, params, tokens)
    _set("a2aint8")
    opt = _logits(cfg, params, tokens)
    denom = np.abs(base).mean() + 1e-6
    assert np.abs(opt - base).mean() / denom < 0.03
    assert not np.array_equal(opt, base)        # the wire is quantized


# -- the port against the reference, the same flags ------------------------
@pytest.mark.parametrize("arch,variant,S", [
    ("gemma3-4b", "banded", 32),
    ("gemma3-4b", "allopt", 32),
    ("qwen3-moe-235b-a22b", "spresid", 16),
    ("qwen3-moe-235b-a22b", "paperfaithful", 16),
    ("qwen3-moe-235b-a22b", "a2aint8", 16),
    ("kimi-k2-1t-a32b", "a2aint8", 16),
])
def test_the_port_under_a_variant_equals_the_reference(arch, variant, S):
    cfg, params, tokens, rcfg, rparams = _setup(arch, S, "float32")
    _set(variant)
    np.testing.assert_allclose(_logits(cfg, params, tokens),
                               _ref_logits(rcfg, rparams, tokens),
                               rtol=F32_TOL, atol=F32_TOL)


# -- a2a_int8 on one device ---------------------------------------------
def test_quantize_rows_is_the_references_arithmetic():
    """Per row absmax / 127 (floor 1e-12), round half to even, ±127:
    the reference's ``_a2a_maybe_int8`` on one device, bit for bit."""
    from repro.models import moe as ref_moe
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 32)).astype(np.float32)
    x[0, 0] = 0.0                                  # the 1e-12 floor
    x[1, 1, :4] = [127.0 * 0.5, -127.0 * 1.5, 0.0, 1.0]   # ties
    x[1, 1, 4:] = 0.25
    q, scale = moe.quantize_rows(torch.from_numpy(x))
    got = (q.float() * scale).numpy()
    ref_perfcfg.set_flags(a2a_int8=True)
    # the reference's exchange over an axis of one: [1 (axis), 1, rows, d]
    want = jax.jit(lambda a: jax.vmap(
        lambda r: ref_moe._a2a_maybe_int8(r, "model"), axis_name="model")(
            a))(jnp.asarray(x).reshape(1, 1, -1, 32)).reshape(x.shape)
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    assert np.array_equal(got, np.asarray(want))


def test_a2a_int8_quantizes_one_devices_two_exchanges(monkeypatch):
    """On one device the rows sent out and the rows sent back are each
    quantized once a layer (the reference's two points at M = 1); with
    the flag off, neither."""
    cfg, params, tokens, _, _ = _setup("qwen3-moe-235b-a22b", 16, "float32")
    calls = []
    real = moe.quantize_rows

    def counted(t):
        calls.append(tuple(t.shape))
        return real(t)
    monkeypatch.setattr(moe, "quantize_rows", counted)
    _logits(cfg, params, tokens)
    assert calls == []
    perfcfg.set_flags(a2a_int8=True)
    _logits(cfg, params, tokens)
    n_moe = cfg.n_layers - cfg.first_k_dense
    assert len(calls) == 2 * n_moe


def test_c30_the_references_a2a_rule_needs_the_smoke_width():
    """ROADMAP C30: the reference's own test of ``a2a_int8`` (mean |Δ| /
    mean |base| below 0.03, ``tests/test_perf_variants.py``) holds at the
    smoke configs' width, not at qwen3-moe's 128 experts a token choosing
    8: there the reference's own logits move 0.15-0.17 (bf16, 4 layers,
    d 256), the quantized rows' outputs flipping later layers' routing.
    The port's one-device pass moves the same way, and with the flag
    off's routing replayed the move is the wire's alone."""
    fields = dict(n_layers=4, d_model=256, d_ff=96, n_heads=8, n_kv_heads=4,
                  head_dim=64, vocab_size=4096)
    full = ref_registry.get_config("qwen3-moe-235b-a22b")
    rcfg = dataclasses.replace(full, **fields)
    assert (rcfg.n_experts, rcfg.top_k) == (128, 8)
    rparams = RM.init(jax.random.PRNGKey(0), rcfg)
    cfg = dataclasses.replace(registry.get_config("qwen3-moe-235b-a22b"),
                              **fields)
    params = carry.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), cfg, "cpu")
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0,
                                           cfg.vocab_size))
    base = _ref_logits(rcfg, rparams, tokens)
    _set("a2aint8")
    opt = _ref_logits(rcfg, rparams, tokens)

    def rel(a, b):
        return np.abs(a - b).mean() / (np.abs(b).mean() + 1e-6)
    assert rel(opt, base) > 0.1
    got = _logits(cfg, params, tokens)
    perfcfg.reset()
    moe.moe_apply.record = []
    try:
        port_base = _logits(cfg, params, tokens)
        ids = [r["expert_id"] for r in moe.moe_apply.record]
    finally:
        moe.moe_apply.record = None
    assert rel(got, port_base) > 0.1
    perfcfg.set_variant("a2aint8")
    moe.moe_apply.replay = ids
    try:
        replayed = _logits(cfg, params, tokens)
    finally:
        moe.moe_apply.replay = None
    assert rel(replayed, port_base) < 0.05
