"""The recurrent scans under autograd against the JAX package: rwkv6's
WKV scan (``rwkv6.WKVChunked``, the port's backward that holds one group
of chunks at a time, and ``wkv_chunked_plain``, plain autograd a chunk
at a time) and mamba2's SSD scan, causal conv and block, which train
under plain autograd; each against ``jax.vjp`` of the reference's
function (``repro.models.rwkv6._wkv_chunked``, ``repro.models.mamba2.
_ssd_chunked``, ...), on f32 inputs made with numpy from a seed, from a
nonzero state and with a cotangent on the state out, over 3 chunks of 8.

Tolerances, each with its reason:

  - gradients, per input: rtol 1e-5 and atol 1e-5 x the input's largest
    |gradient| (``GRAD_TOL``): the same f32 terms summed in other orders
    (the chunks batched, the carry's products, group by group in the
    port's backward); measured at most 7.7e-7 of it.
  - ROADMAP C22 (decays of exp(-14) to exp(-20) a step): against an
    f64 step-by-step recurrence (the scan's definition), rtol and atol
    1e-3 x the largest |gradient| (``C22_TOL``). A chunk's cumulative
    log-decay reaches -100 to -400 there, where one f32 ulp is 7.6e-6
    to 3e-5; every exp(cum_t - cum_s) carries that as a relative error,
    and the log-decay's gradient is a reverse cumsum of such terms,
    which cancel: measured 1.5e-5 of lw's largest gradient (WKV) and
    1.5e-4 of a_log's (SSD), while an f32 step-by-step recurrence, which
    forms no cum, stays within 1e-7; the other inputs' within
    ``GRAD_TOL``.
  - the Function against no-grad, the backward twice, and every remat
    policy: the same operations on the same inputs, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as RMB
from repro.models import model as RM
from repro.models import rwkv6 as RW
from repro_torch.models import mamba2 as TMB
from repro_torch.models import rematcfg
from repro_torch.models import rwkv6 as TW
from test_torch_recurrent import (_cfgs, _pair, _rand_layer, _rwkv_layer,
                                  _rwkv_state, _ssd_inputs, _wkv_inputs)

torch.set_num_threads(2)
GRAD_TOL = 1e-5
C22_TOL = 1e-3


def _cotangents(rng, outs):
    """One N(0, 1) cotangent a port output: (the reference's, the
    port's)."""
    pairs = [_pair(rng, tuple(o.shape)) for o in outs]
    return tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)


def _port_grads(fn, args, cots):
    leaves = [a.detach().clone().requires_grad_() for a in args]
    outs = fn(*leaves)
    return outs, torch.autograd.grad(outs, leaves, cots)


def _grads_close(got, want, names, tol=GRAD_TOL):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        g = g.detach().float().numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * max(float(np.abs(w).max()),
                                                  1e-30), err_msg=name)


# ---------------------------------------------------------------------------
# rwkv6: the WKV scan
# ---------------------------------------------------------------------------
WKV_NAMES = ("r", "k", "v", "lw", "u", "state")
WKV_CASES = [("function", None), ("function", 1), ("plain", None)]


def _wkv(scan):
    if scan == "function":
        return lambda *a: TW._wkv_chunked(*a, 8)
    return lambda *a: TW.wkv_chunked_plain(*a, 8)


@pytest.mark.parametrize("scan,d_bytes", WKV_CASES,
                         ids=["function", "function-groups-of-1", "plain"])
def test_wkv_gradients_match_jax_vjp(scan, d_bytes, monkeypatch):
    """3 chunks of 8 from a nonzero state at ``log_rate`` -2; ``d_bytes``
    1 makes every chunk a group of its own, so dS crosses two group
    boundaries in the backward."""
    if d_bytes is not None:
        monkeypatch.setattr(TW, "D_BYTES", d_bytes)
    rng = np.random.default_rng(40)
    ins = _wkv_inputs(rng, "float32")
    ref_out, pull = jax.vjp(lambda *a: RW._wkv_chunked(*a, 8),
                            *(p[0] for p in ins))
    ref_cot, cot = _cotangents(rng, ref_out)
    outs, got = _port_grads(_wkv(scan), [p[1] for p in ins], cot)
    if scan == "function":
        assert type(outs[0].grad_fn).__name__ == "WKVChunkedBackward"
    _grads_close(got, pull(ref_cot), WKV_NAMES)


def _wkv_f64(r, k, v, lw, u, S):
    """The scan's definition, step by step in f64: o_t = r_tᵀ (diag(u)
    k_t v_tᵀ + S_t), S_{t+1} = diag(exp(lw_t)) S_t + k_t v_tᵀ."""
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append((r[:, t, :, None, :] @ (S + u[None, :, :, None] * kv)
                     ).squeeze(-2))
        S = torch.exp(lw[:, t])[..., None] * S + kv
    return torch.stack(outs, dim=1), S


def test_c22_steep_decays_give_the_reference_nan_and_the_port_finite():
    """ROADMAP C22. At ``log_rate`` 3 a step decays by ~exp(-20), so the
    unmasked decay exp(cum_{t-1} - cum_s) overflows to inf for s >= t.
    The reference masks it after ``exp`` (``jnp.where(tri, D, 0)``), and
    exp's backward gives 0 x inf = NaN there: its lw gradient is NaN. The
    port masks the exponent before ``exp``: its gradients are finite,
    equal the reference's where those are finite, and equal an f64
    recurrence everywhere."""
    rng = np.random.default_rng(41)
    ins = _wkv_inputs(rng, "float32", log_rate=3.0)
    ref_out, pull = jax.vjp(lambda *a: RW._wkv_chunked(*a, 8),
                            *(p[0] for p in ins))
    ref_cot, cot = _cotangents(rng, ref_out)
    want = pull(ref_cot)
    assert np.isnan(np.asarray(want[3])).any()                 # lw
    finite = [i for i, w in enumerate(want) if np.isfinite(w).all()]
    assert finite == [0, 1, 2, 4, 5]
    for scan in ("function", "plain"):
        _, got = _port_grads(_wkv(scan), [p[1] for p in ins], cot)
        _grads_close([got[i] for i in finite], [want[i] for i in finite],
                     [WKV_NAMES[i] for i in finite])
        _, exact = _port_grads(_wkv_f64, [p[1].double() for p in ins],
                               tuple(c.double() for c in cot))
        _grads_close(got, [e.numpy() for e in exact], WKV_NAMES, C22_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("d_bytes", [TW.D_BYTES, 1])
def test_wkv_function_forward_is_the_no_grad_scan_bit_for_bit(
        dtype, d_bytes, monkeypatch):
    """The Function's forward is the serving scan (steep decays too), and
    its backward run twice gives the same bits."""
    monkeypatch.setattr(TW, "D_BYTES", d_bytes)
    rng = np.random.default_rng(42)
    ins = [p[1] for p in _wkv_inputs(rng, "float32", log_rate=3.0)]
    ins = [t.to(dtype) if i < 3 else t for i, t in enumerate(ins)]
    with torch.no_grad():
        want, want_s = TW._wkv_chunked(*ins, 8)
    leaves = [t.clone().requires_grad_() for t in ins]
    got, got_s = TW._wkv_chunked(*leaves, 8)
    assert want.grad_fn is None and got.grad_fn is not None
    assert torch.equal(got, want) and torch.equal(got_s, want_s)
    cot = (torch.randn(got.shape).to(dtype), torch.randn(got_s.shape))
    first = torch.autograd.grad((got, got_s), leaves, cot, retain_graph=True)
    again = torch.autograd.grad((got, got_s), leaves, cot)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("policy", rematcfg.POLICIES)
def test_wkv_function_saves_no_tensor_larger_than_one_groups_decay(
        policy, monkeypatch):
    """One time-mix at 3 chunks of 16 with ``D_BYTES`` 1 (a group is one
    chunk) under each remat policy: every tensor that autograd saves
    through the forward and the backward (an outer ``saved_tensors_hooks``
    sees the layer's own saves under policy none, and the backward's
    recompute of each group under all three) is at most one chunk's D,
    [B, H, 1, 16, 16, hd] f32, and the recompute saves D of that size.
    Autograd straight through the scan's three chunks at once would save
    D of all three."""
    monkeypatch.setattr(TW, "D_BYTES", 1)
    ref_cfg, cfg, _, tp = _rwkv_layer("float32", 43)
    rng = np.random.default_rng(44)
    B, C, hd = 2, 16, cfg.rwkv_head_size
    H = cfg.d_model // hd
    one_d = B * H * C * C * hd * 4
    _, x = _pair(rng, (B, 3 * C, cfg.d_model))
    _, st = _rwkv_state(rng, cfg, "float32", B)
    leaves = [x.requires_grad_()] + [t.requires_grad_()
                                    for t in tp["tm"].values()]
    layer = rematcfg.wrap(lambda p, x, s: TW._time_mix(
        p, x, cfg, s, chunk=C)[0], policy)
    sizes = []

    def pack(t):
        sizes.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = layer(tp["tm"], x, st)
        torch.autograd.grad(out.square().sum(), leaves)
    assert max(sizes) == one_d, (max(sizes), one_d)
    # the bound bites: autograd through the scan's chunks at once
    r, k, v, lw = (torch.randn(B, 3 * C, H, hd, requires_grad=True)
                   for _ in range(4))
    sizes.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        TW._wkv_group(r, k, v, -lw.exp(), tp["tm"]["u"], st["wkv"], C)
    assert max(sizes) == 3 * one_d


def test_rwkv6_block_gradients_match_jax_vjp():
    """One layer (time-mix and channel-mix) from a nonzero state, with
    cotangents on x and on every state leaf: the gradients of every
    param, x and the state."""
    ref_cfg, cfg, p, tp = _rwkv_layer("float32", 45)
    rng = np.random.default_rng(46)
    x, tx = _pair(rng, (2, 24, cfg.d_model))
    st, tst = _rwkv_state(rng, cfg, "float32", 2)
    _block_grads_match(lambda *a: RW.block_apply(a[0], a[1], ref_cfg, a[2],
                                                 chunk=8),
                       lambda *a: TW.block_apply(a[0], a[1], cfg, a[2],
                                                 chunk=8),
                       (p, x, st), (tp, tx, tst), rng)


# ---------------------------------------------------------------------------
# mamba2: plain autograd through the SSD scan, the conv and the block
# ---------------------------------------------------------------------------
def test_ssd_gradients_match_jax_vjp():
    rng = np.random.default_rng(47)
    ins = _ssd_inputs(rng, "float32")
    ref_out, pull = jax.vjp(lambda *a: RMB._ssd_chunked(*a, 8),
                            *(p[0] for p in ins))
    ref_cot, cot = _cotangents(rng, ref_out)
    _, got = _port_grads(lambda *a: TMB._ssd_chunked(*a, 8),
                         [p[1] for p in ins], cot)
    _grads_close(got, pull(ref_cot), ("x", "dt", "B", "C", "a_log", "h0"))


def _ssd_f64(x, dt, B_, C_, a_log, h):
    """The SSD scan's definition, step by step in f64: h_t = a_t h_{t-1}
    + dt_t x_t B_tᵀ, y_t = C_t h_t."""
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(a_log[:, t])[:, :, None, None] * h + (
            dt[:, t, :, None] * x[:, t])[..., None] * B_[:, t, None, None, :]
        ys.append((h @ C_[:, t, None, :, None]).squeeze(-1))
    return torch.stack(ys, dim=1), h


def test_c22_the_ssd_scan_masks_before_exp_too():
    """ROADMAP C22 in the SSD scan: with decays of ~exp(-14) a step, the
    reference's exp(cum_t - cum_s) overflows above the diagonal (s > t),
    and its masked-after-exp backward gives NaN; the port's (which masks
    the exponent) is finite, equals the reference's where that is finite
    and an f64 recurrence everywhere."""
    rng = np.random.default_rng(51)
    ins = list(_ssd_inputs(rng, "float32"))
    a = _pair(rng, (3,), "float32", 0.1, 3.0)
    ins[4] = (-jnp.exp(a[0]) * ins[1][0], -torch.exp(a[1]) * ins[1][1])
    ref_out, pull = jax.vjp(lambda *a: RMB._ssd_chunked(*a, 8),
                            *(p[0] for p in ins))
    ref_cot, cot = _cotangents(rng, ref_out)
    want = pull(ref_cot)
    names = ("x", "dt", "B", "C", "a_log", "h0")
    finite = [i for i, w in enumerate(want) if np.isfinite(w).all()]
    assert len(finite) < len(want)
    _, got = _port_grads(lambda *a: TMB._ssd_chunked(*a, 8),
                         [p[1] for p in ins], cot)
    _grads_close([got[i] for i in finite], [want[i] for i in finite],
                 [names[i] for i in finite])
    _, exact = _port_grads(_ssd_f64, [p[1].double() for p in ins],
                           tuple(c.double() for c in cot))
    _grads_close(got, [e.numpy() for e in exact], names, C22_TOL)


def test_causal_conv_gradients_match_jax_vjp():
    rng = np.random.default_rng(48)
    x, tx = _pair(rng, (2, 24, 24))
    w, tw = _pair(rng, (TMB.CONV_K, 24), "float32", 0.5)
    s, ts = _pair(rng, (2, TMB.CONV_K - 1, 24))
    ref_out, pull = jax.vjp(lambda *a: RMB._causal_conv(*a, single=False),
                            x, w, s)
    ref_cot, cot = _cotangents(rng, ref_out)
    _, got = _port_grads(TMB._causal_conv, [tx, tw, ts], cot)
    _grads_close(got, pull(ref_cot), ("x", "w", "conv_state"))


def test_mamba2_block_gradients_match_jax_vjp():
    ref_cfg, cfg = _cfgs("zamba2-1.2b")
    ref = RM.init(jax.random.PRNGKey(0), ref_cfg)
    p, tp = _rand_layer(ref["mamba"], np.random.default_rng(49), "float32")
    rng = np.random.default_rng(50)
    x, tx = _pair(rng, (2, 24, cfg.d_model))
    nh = cfg.d_inner // cfg.ssm_headdim
    h, th = _pair(rng, (2, nh, cfg.ssm_headdim, cfg.ssm_state), "float32",
                  0.3)
    c, tc = _pair(rng, (2, TMB.CONV_K - 1, cfg.d_inner + 2 * cfg.ssm_state))
    _block_grads_match(lambda *a: RMB.block_apply(a[0], a[1], ref_cfg, a[2],
                                                  chunk=8),
                       lambda *a: TMB.block_apply(a[0], a[1], cfg, a[2],
                                                  chunk=8),
                       (p, x, {"h": h, "conv": c}),
                       (tp, tx, {"h": th, "conv": tc}), rng)


def _block_grads_match(ref_fn, port_fn, ref_args, port_args, rng):
    """vjp of ``fn(params, x, state) -> (x, state)`` in both packages,
    with the same cotangents, compared leaf by leaf (params, x, state),
    each tree's leaves in sorted-key order as ``jax.tree`` flattens."""
    ref_out, pull = jax.vjp(ref_fn, *ref_args)
    ref_leaves, tree = jax.tree.flatten(ref_out)
    pairs = [_pair(rng, tuple(o.shape)) for o in ref_leaves]
    want = jax.tree.flatten(pull(jax.tree.unflatten(
        tree, [p[0] for p in pairs])))[0]
    names = [jax.tree_util.keystr(path) for path, _ in
             jax.tree_util.tree_flatten_with_path(ref_args)[0]]
    args = _requiring_grad(port_args)
    leaves = _sorted_leaves(args)
    got = torch.autograd.grad(_sorted_leaves(port_fn(*args)), leaves,
                              [p[1] for p in pairs])
    assert len(got) == len(want) == len(names)
    _grads_close(got, want, names)


def _requiring_grad(tree):
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_requiring_grad(v) for v in tree)
    return tree.detach().clone().requires_grad_()


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _sorted_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _sorted_leaves(v)]
    return [tree]
