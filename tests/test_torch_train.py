"""The port's training pieces against the JAX package: attention's
gradient, the cross-entropy, AdamW, the data and the checkpoints.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU, where B4 is its plain version.

Tolerances, each with its reason:

  - attention, f32, 1e-5 (rtol and atol): the two sum the same products
    in other orders (the reference's blocks of 8-512 keys, the port's
    tiles of 64 forward and blocks of 512 backward); gradients of N(0, 1)
    inputs are O(1) and differ by ~5e-6 at most.
  - cross-entropy, f32: 1e-6 relative on the loss and its gradient (a
    sum over V in another order); the port's gather against the
    one-hot contraction it replaces: bit for bit.
  - AdamW, f32 params within 1e-6 relative after 5 steps (the global
    norm is summed over other leaves in another order, so the clip
    factor may differ in its last bit); int8 payloads within one quantum
    and the count of those off by one stated by the test.
  - data and checkpoints: bit for bit.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from hypothesis_compat import given, settings, strategies as st
from repro.checkpoint.manager import CheckpointManager as RefCheckpoints
from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.data.pipeline import SyntheticLMData as RefData
from repro.models import layers as RL
from repro.models import model as RM
from repro.train import optimizer as ref_opt
from repro_torch import carry
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base, registry
from repro_torch.data.pipeline import SyntheticLMData, to_device
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as TL
from repro_torch.train import optimizer as opt

torch.set_num_threads(2)
F32_TOL = 1e-5


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_train_configs_equal_the_reference_field_for_field():
    cfg = registry.get_smoke_config("qwen3-4b")
    ref_cfg = ref_registry.get_smoke_config("qwen3-4b")
    assert dataclasses.asdict(base.OptimizerConfig()) == \
        dataclasses.asdict(ref_base.OptimizerConfig())
    mine = dataclasses.asdict(base.TrainConfig(model=cfg))
    ref = dataclasses.asdict(ref_base.TrainConfig(model=ref_cfg))
    # the checkpoint directory follows $TMPDIR (the reference's is /tmp)
    assert mine.pop("checkpoint_dir").endswith("repro_ckpt")
    ref.pop("checkpoint_dir")
    assert mine == ref


# ---------------------------------------------------------------------------
# attention: the autograd Function against jax.vjp of the reference
# ---------------------------------------------------------------------------
ATTN_CASES = {
    # B, S, Sk, H, KV, hd, causal, window
    "causal GQA, two backward blocks": (2, 600, 600, 4, 2, 16, True, 0),
    "causal window 100": (2, 600, 600, 4, 2, 16, True, 100),
    "non-causal Sk != S": (2, 40, 700, 4, 1, 16, False, 0),
    "causal G=1": (2, 200, 200, 2, 2, 32, True, 0),
}


def _attn_inputs(B, S, Sk, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd),
                          (B, S, H, hd))]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_gradients_match_jax_vjp(case):
    B, S, Sk, H, KV, hd, causal, window = ATTN_CASES[case]
    q, k, v, dout = _attn_inputs(B, S, Sk, H, KV, hd)
    out, vjp = jax.vjp(lambda q, k, v: RL.blockwise_attention(
        q, k, v, causal=causal, window=window), q, k, v)
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = TL.blockwise_attention(tq, tk, tv, causal=causal, window=window)
    assert got.grad_fn is not None
    got.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=F32_TOL, atol=F32_TOL)
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", ATTN_CASES)
def test_plain_lse_matches_the_references_flash_fwd(case):
    """The reference's blockwise_attention cuts q and k into blocks and
    calls ``_flash_fwd``; its lse [B, nq, bq, KV, G] is the port's
    [B, H, S] with H = (KV, G)."""
    B, S, Sk, H, KV, hd, causal, window = ATTN_CASES[case]
    q, k, v, _ = _attn_inputs(B, S, Sk, H, KV, hd)
    G = H // KV
    bq = np.gcd(min(256, S), S)
    bk = np.gcd(min(512, Sk), Sk)
    nq, nk = S // bq, Sk // bk
    qh = jnp.asarray(q).reshape(B, nq, bq, KV, G, hd)
    kh = jnp.moveaxis(jnp.asarray(k).reshape(B, nk, bk, KV, hd), 1, 0)
    vh = jnp.moveaxis(jnp.asarray(v).reshape(B, nk, bk, KV, hd), 1, 0)
    qpos = jnp.arange(S, dtype=jnp.int32).reshape(nq, bq)
    kpos = jnp.arange(Sk, dtype=jnp.int32).reshape(nk, bk)
    _, want = RL._flash_fwd(qh, kh, vh, qpos, kpos, causal,
                            jnp.int32(window), 0.0, 1.0 / np.sqrt(hd))
    want = np.asarray(want).reshape(B, S, KV, G)
    out, lse = fa.flash_attention_gqa_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        window=window, return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    got = lse.view(B, KV, G, S).permute(0, 3, 1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    # the wrapper returns the same pair on the CPU
    out2, lse2 = fa.flash_attention_gqa(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        window=window, return_lse=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


def test_the_wrapper_raises_on_inputs_that_require_grad():
    q, k, v, _ = (torch.from_numpy(x) for x in _attn_inputs(1, 8, 8, 2, 1,
                                                            16))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="computes no gradient"):
        fa.flash_attention_gqa(q, k, v)
    with pytest.raises(RuntimeError, match="computes no gradient"):
        fa.flash_attention(q[:, :, 0], k[:, :, 0], v[:, :, 0])
    with torch.no_grad():                 # serving: no history to lose
        fa.flash_attention_gqa(q, k, v)
    out = TL.blockwise_attention(q, k, v)  # training: the Function
    assert out.grad_fn is not None and "Attention" in out.grad_fn.name()
    # without grad-requiring inputs, blockwise_attention is B4 as it was
    plain = TL.blockwise_attention(q.detach(), k, v)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


def test_return_lse_on_cuda_tensors_never_reaches_the_plain_version(
        monkeypatch):
    def loader_fails(*args, **kwargs):
        raise RuntimeError("kernel loader called")

    def plain_called(*args, **kwargs):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(_build, "kernel", loader_fails)
    monkeypatch.setattr(fa, "flash_attention_gqa_plain", plain_called)
    with FakeTensorMode():
        q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16, device="cuda")
        kv = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(RuntimeError, match="kernel loader called"):
            fa.flash_attention_gqa(q, kv, kv, return_lse=True)


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------
def _one_hot_ce(logits, labels, mask):
    """The reference's formula in PyTorch, with its one-hot contraction."""
    m = logits.detach().amax(dim=-1, keepdim=True)
    shifted = logits - m
    sf = shifted.float()
    m0 = m[..., 0].float()
    lse = torch.log(torch.exp(sf).sum(dim=-1)) + m0
    onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).to(
        logits.dtype)
    ll = (sf * onehot).sum(dim=-1) + m0
    return ((lse - ll) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_the_reference(dtype):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 9, 300)) * 3).astype(np.float32)
    labels = rng.integers(0, 300, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.8).astype(np.float32)
    np_dt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}[dtype]
    lj = jnp.asarray(logits.astype(np_dt))
    want, g_want = jax.value_and_grad(RL.softmax_cross_entropy)(
        lj, jnp.asarray(labels), jnp.asarray(mask))
    lt = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    got = TL.softmax_cross_entropy(lt, torch.from_numpy(labels),
                                   torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8   # one bf16 ulp at 1
    np.testing.assert_allclose(_np(lt.grad), _np(g_want), rtol=tol,
                               atol=tol * float(np.abs(_np(g_want)).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_gather_equals_the_one_hot_bit_for_bit(dtype):
    rng = np.random.default_rng(4)
    logits = torch.from_numpy((rng.standard_normal((3, 17, 500)) * 4)
                              .astype(np.float32)).to(getattr(torch, dtype))
    labels = torch.from_numpy(rng.integers(0, 500, (3, 17)).astype(np.int32))
    mask = torch.ones(3, 17)
    a = logits.clone().requires_grad_()
    b = logits.clone().requires_grad_()
    la = TL.softmax_cross_entropy(a, labels, mask)
    lb = _one_hot_ce(b, labels, mask)
    la.backward()
    lb.backward()
    assert torch.equal(la, lb)
    assert torch.equal(a.grad, b.grad)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _ref_params(arch="qwen2-0.5b", dtype="float32", seed=0):
    ref_cfg = dataclasses.replace(ref_registry.get_smoke_config(arch),
                                  dtype=dtype)
    cfg = dataclasses.replace(registry.get_smoke_config(arch), dtype=dtype)
    return ref_cfg, cfg, RM.init(jax.random.PRNGKey(seed), ref_cfg)


def _grads_like(ref_params, rng, scale):
    return jax.tree.map(lambda p: jnp.asarray(
        (rng.standard_normal(p.shape) * scale).astype(np.float32)).astype(
            p.dtype), ref_params)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("grad_scale", [1e-4, 3.0], ids=["unclipped",
                                                         "clipped"])
def test_apply_updates_tracks_the_reference_over_five_steps(int8,
                                                            grad_scale):
    """Global norms of ~0.03 (unclipped) and ~900 (clipped to 1)."""
    ref_cfg, cfg, ref = _ref_params()
    oc = dict(lr=1e-2, warmup_steps=2, total_steps=8, int8_states=int8)
    ref_oc, oc_t = ref_base.OptimizerConfig(**oc), base.OptimizerConfig(**oc)
    ref_state = ref_opt.init_state(ref_oc, ref)
    params = carry.lm_params_from_reference(jax.tree.map(np.asarray, ref),
                                            cfg, "cpu")
    state = opt.init_state(oc_t, params)
    rng = np.random.default_rng(5)
    upd = jax.jit(lambda p, g, s: ref_opt.apply_updates(ref_oc, p, g, s))
    for _ in range(5):
        g = _grads_like(ref, rng, grad_scale)
        ref, ref_state, ref_m = upd(ref, g, ref_state)
        tg = carry.lm_params_from_reference(jax.tree.map(np.asarray, g),
                                            cfg, "cpu")
        params, state, m = opt.apply_updates(oc_t, params, tg, state)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]),
                                   rtol=1e-7)
    assert int(state["step"]) == int(ref_state["step"]) == 5
    want = carry.lm_params_from_reference(jax.tree.map(np.asarray, ref),
                                          cfg, "cpu")
    moved, n_params = 0, 0
    for (path, a), (_, b) in zip(opt.flatten(params), opt.flatten(want)):
        close = torch.isclose(a, b, rtol=1e-6,
                              atol=1e-6 * float(b.abs().max()))
        moved += int((~close).sum())
        n_params += a.numel()
        if not int8:
            assert close.all(), path
        # int8: an entry whose m or v payload was stored one quantum off
        # moves by less than lr x 1 (its update's size)
        assert float((a - b).abs().max()) < oc["lr"], path
    ref_st = carry.opt_state_from_reference(
        jax.tree.map(np.asarray, ref_state), cfg, "cpu")
    off, total = 0, 0
    for key in ("m", "v"):
        for (path, a), (_, b) in zip(opt.flatten(state[key]),
                                     opt.flatten(ref_st[key])):
            if int8:
                dq = (a.q.int() - b.q.int()).abs()
                assert int(dq.max()) <= 1, path
                off += int((dq == 1).sum())
                total += dq.numel()
                np.testing.assert_allclose(a.scale.numpy(), b.scale.numpy(),
                                           rtol=1e-5, err_msg=str(path))
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                           atol=1e-6 * float(
                                               b.abs().max()),
                                           err_msg=str(path))
    # int8: payloads one quantum apart where a sum's last bit (the global
    # norm over other leaves in another order, the clip factor) moved a
    # value across a rounding boundary: measured 1 of 181,376 entries,
    # and up to 4 of 90,688 params; at most 1 in 10^4 of either
    print(f"int8 payloads one quantum off: {off} of {total}; params "
          f"outside 1e-6: {moved} of {n_params}")
    assert off <= total // 10_000 and moved <= n_params // 10_000, (
        off, moved)


def test_lr_schedule_matches_the_reference():
    for oc in (dict(lr=3e-4, warmup_steps=100, total_steps=10_000),
               dict(lr=1e-2, warmup_steps=0, total_steps=7)):
        ref_oc, oc_t = ref_base.OptimizerConfig(**oc), \
            base.OptimizerConfig(**oc)
        for step in (0, 1, 3, 50, 99, 100, 101, 5000, 10_000, 20_000):
            want = float(ref_opt.lr_schedule(ref_oc, jnp.int32(step)))
            got = float(opt.lr_schedule(oc_t, torch.tensor(step,
                                                           dtype=torch.int32)))
            np.testing.assert_allclose(got, want, rtol=1e-6)


def test_clip_scales_to_the_grad_clip():
    """Grads of global norm 10 with grad_clip 1: the norm is reported
    before clipping, and the first step moves each f32 param by lr x
    m̂ / (sqrt(v̂) + eps) = lr x sign(g) (times 1 - eps), whatever the
    clip; with weight decay off the move is exactly that."""
    oc = base.OptimizerConfig(lr=0.5, warmup_steps=0, total_steps=1,
                              weight_decay=0.0, min_lr_ratio=1.0)
    g = torch.full((4, 25), 1.0)                      # norm 10
    p = torch.zeros(4, 25)
    params, state, m = opt.apply_updates(oc, {"w": p}, {"w": g},
                                         opt.init_state(oc, {"w": p}))
    assert float(m["grad_norm"]) == pytest.approx(10.0)
    np.testing.assert_allclose(params["w"].numpy(), -0.5, rtol=1e-6)
    # the clipped gradient went into m: (1 - b1) x g / 10
    np.testing.assert_allclose(state["m"]["w"].numpy(), 0.1 * 0.1,
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ref_registry.ARCH_NAMES)
def test_decayed_leaves_are_the_references(arch):
    """The reference's ``_decayable`` on its own tree's paths against the
    port's on the same leaves' names: the same set (``w_up`` and the MoE
    router undecayed, QKV biases decayed)."""
    ref_cfg = ref_registry.get_smoke_config(arch)
    ref = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), ref_cfg))
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    want = {(jax.tree_util.keystr(path), ref_opt._decayable(path))
            for path, _ in flat}
    got = {(jax.tree_util.keystr(path), opt.decayable(path[-1].key))
           for path, _ in flat}
    assert got == want
    assert not opt.decayable("w_up") and not opt.decayable("router")
    assert opt.decayable("bq") and opt.decayable("wq")
    assert opt.decayable("w_gate") and opt.decayable("w_down")


@settings(max_examples=25, deadline=None)
@given(st.tuples(st.integers(1, 3), st.sampled_from([1, 7, 256, 300])),
       st.integers(0, 10_000), st.sampled_from([1e-3, 1.0, 1e3]))
def test_quantize_round_trip_is_the_references_and_within_half_a_quantum(
        shape, seed, scale):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    ref = ref_opt.quantize_block(jnp.asarray(x))
    got = opt.quantize_block(torch.from_numpy(x))
    assert got.shape == ref.shape == shape
    assert np.array_equal(got.q.numpy(), np.asarray(ref.q))
    assert np.array_equal(got.scale.numpy(), np.asarray(ref.scale))
    back = opt.dequantize_block(got)
    assert np.array_equal(back.numpy(), np.asarray(
        ref_opt.dequantize_block(ref)))
    floor = opt._quantum_floor(got)
    assert np.array_equal(floor.numpy(),
                          np.asarray(ref_opt._quantum_floor(ref)))
    # round to nearest: within half a quantum, plus the division's ulp
    assert (back - torch.from_numpy(x)).abs().le(
        floor * (1 + 1e-6)).all()


def test_quantize_a_scalar_as_the_reference():
    for v in (0.0, -2.5):
        ref = ref_opt.quantize_block(jnp.float32(v))
        got = opt.quantize_block(torch.tensor(v))
        assert got.shape == () and np.array_equal(got.scale.numpy(),
                                                  np.asarray(ref.scale))
        assert float(opt.dequantize_block(got)) == float(
            ref_opt.dequantize_block(ref))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-4b", "musicgen-medium",
                                  "llama-3.2-vision-90b"])
def test_batches_are_the_references_bit_for_bit(arch):
    cfg = registry.get_smoke_config(arch)
    ref_cfg = ref_registry.get_smoke_config(arch)
    mine, ref = SyntheticLMData(cfg, 4, 16, seed=3), RefData(ref_cfg, 4, 16,
                                                            seed=3)
    for step in (0, 1, 7, 10_000):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key]), (step, key)
        on = to_device(a, torch.device("cpu"))
        for key in a:
            assert np.array_equal(on[key].numpy(), a[key])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _ref_train_state(int8, dtype="bfloat16", arch="qwen3-4b"):
    ref_cfg, cfg, ref = _ref_params(arch, dtype)
    oc = ref_base.OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                                  int8_states=int8)
    state = ref_opt.init_state(oc, ref)
    g = _grads_like(ref, np.random.default_rng(6), 0.1)
    ref, state, _ = jax.jit(lambda p, g, s: ref_opt.apply_updates(
        oc, p, g, s))(ref, g, state)
    return cfg, {"params": ref, "opt": state}


def _as_torch(tree):
    """A reference tree (jax arrays, QTensors) as CPU tensors in the same
    layout: what the port's manager is given to write the same files."""
    def leaf(x):
        if isinstance(x, ref_opt.QTensor):
            return opt.QTensor(q=_as_torch(x.q), scale=_as_torch(x.scale),
                               shape=x.shape)
        return carry._tensor(np.asarray(x), torch.device("cpu"))
    return jax.tree.map(leaf, tree,
                        is_leaf=lambda x: isinstance(x, ref_opt.QTensor))


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-7b", "zamba2-1.2b"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_a_reference_checkpoint_restores_into_the_port(tmp_path, int8, arch):
    """The transformer's tree and the recurrent ones (``blocks`` or
    ``mamba``, one dict a layer once carried, and ``shared_attn``)."""
    cfg, tree = _ref_train_state(int8, arch=arch)
    RefCheckpoints(str(tmp_path)).save(3, tree, {"next_step": 4})
    raw, extra = CheckpointManager(str(tmp_path)).restore(3)
    assert extra == {"next_step": 4}
    params = carry.lm_params_from_reference(raw["params"], cfg, "cpu")
    state = carry.opt_state_from_reference(raw["opt"], cfg, "cpu")
    host = jax.tree.map(np.asarray, tree)      # QTensors of numpy arrays
    want_p = carry.lm_params_from_reference(host["params"], cfg, "cpu")
    want_s = carry.opt_state_from_reference(host["opt"], cfg, "cpu")
    assert params["embed"]["table"].dtype == torch.bfloat16
    for got, want in ((params, want_p), (state, want_s)):
        fg, fw = opt.flatten(got), opt.flatten(want)
        assert [p for p, _ in fg] == [p for p, _ in fw]
        for (path, a), (_, b) in zip(fg, fw):
            if isinstance(b, opt.QTensor):
                assert a.shape == b.shape
                assert torch.equal(a.q, b.q) and torch.equal(a.scale,
                                                             b.scale)
            else:
                assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_the_port_writes_the_references_files(tmp_path, int8):
    """The same tree through both managers: equal manifests and
    byte-equal .npy files (bf16 as uint16, QTensors as two files)."""
    _, tree = _ref_train_state(int8)
    RefCheckpoints(str(tmp_path / "ref")).save(2, tree, {"next_step": 3})
    CheckpointManager(str(tmp_path / "port")).save(2, _as_torch(tree),
                                                   {"next_step": 3})
    a, b = tmp_path / "ref" / "step_000000002", \
        tmp_path / "port" / "step_000000002"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    assert json.loads((a / "manifest.json").read_text()) == \
        json.loads((b / "manifest.json").read_text())
    for name in os.listdir(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_the_ports_own_checkpoints_round_trip_in_place(tmp_path):
    _, cfg, ref = _ref_params("qwen3-4b", "bfloat16")
    params = carry.lm_params_from_reference(jax.tree.map(np.asarray, ref),
                                            cfg, "cpu")
    oc = base.OptimizerConfig(int8_states=True)
    state = opt.init_state(oc, params)
    tree = {"params": params, "opt": state}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save_async(step, tree, {"next_step": step + 1})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]             # keep=2
    (tmp_path / "step_000000009.tmp").mkdir()     # an unfinished write
    assert mgr.latest_step() == 3
    manifest = json.loads((tmp_path / "step_000000003" / "manifest.json")
                          .read_text())
    assert set(manifest) == {"step", "extra", "leaves"}
    assert manifest["leaves"][0]["files"] == ["arr_0_q.npy", "arr_0_s.npy"]
    assert {e["kind"] for e in manifest["leaves"]} == {"array", "qtensor"}
    like = opt.tree_map(torch.zeros_like, params)
    like_state = opt.init_state(oc, like)
    like_state["step"].fill_(7)
    restored, extra = mgr.restore(3, {"params": like, "opt": like_state})
    assert extra == {"next_step": 4} and restored["params"] is like
    for (_, a), (_, b) in zip(opt.flatten(like), opt.flatten(params)):
        assert torch.equal(a, b)
    assert int(like_state["step"]) == 0
