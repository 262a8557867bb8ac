"""The port's MoE block (``repro_torch.models.moe``) against the JAX package.

``repro.models.moe.moe_apply`` runs jitted on ``single_device_ctx()``
(its ``shard_map`` over a 1 x 1 mesh), the port on the CPU; one layer's
params and the input are made with numpy from a seed and handed to both.

The reference returns only (y, aux). Which experts it chose and which
assignments it dropped are read from its output: with ``w_down`` of
expert e writing only coordinates ``[e·d/E, (e+1)·d/E)`` and no shared
expert, the nonzero blocks of a token's output name the experts that
computed it. A run at capacity factor 100 (nothing dropped) gives the
chosen set, a run at the config's factor the kept set.

Tolerances, each with its reason:

  - float32, 1e-5 (rtol and atol) on y and aux: the same products
    summed in other orders (batched against per-expert matmuls, the
    router's dot, softmax's sum).
  - bfloat16, 2^-7 relative to max |y| (one ulp of the largest entry):
    both round the same f32 sums, taken in other orders, to bf16 after
    each product, the SwiGLU's steps and each combine add, so an entry
    may differ by an ulp of an intermediate; measured below that.
  - expert ids, kept and dropped sets: identical (routing is held bit
    for bit; the random router leaves no near-ties at these seeds).
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
from repro.models import moe as ref_moe
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as TL
from repro_torch.models import moe

torch.set_num_threads(2)
F32_TOL = 1e-5
BF16_REL = 2.0 ** -7
ARCHS = ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"]
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}
# (B, S): a prefill, and a decode step of 4 sequences; at 16 experts the
# decode step has the full configs' cap_exp of 1 (ceil(ceil(4·2·1.25) /
# 16 · 1.25)), as 128 experts top-8 have, so shared experts drop
SHAPES = {"prefill": (2, 16, None), "decode": (4, 1, 16)}


def _cfgs(arch, dtype="float32", n_experts=None, **kw):
    ref = ref_registry.get_smoke_config(arch)
    ref = dataclasses.replace(ref, dtype=dtype, **kw, **(
        {"n_experts": n_experts} if n_experts else {}))
    mine = ModelConfig(**dataclasses.asdict(ref))
    return ref, mine


def _layer(cfg, seed, blocks=False, router_scale=1.0):
    """One layer's params as numpy f32 arrays (cast by ``_both``).
    ``blocks``: expert e's w_down writes only its own block of
    coordinates, and there is no shared expert."""
    rng = np.random.default_rng(seed)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": rng.standard_normal((d, E)) * router_scale / np.sqrt(d),
         "w_gate": rng.standard_normal((E, d, ff)) / np.sqrt(d),
         "w_up": rng.standard_normal((E, d, ff)) / np.sqrt(d),
         "w_down": rng.standard_normal((E, ff, d)) / np.sqrt(ff)}
    if blocks:
        width = d // E
        mask = np.zeros((E, 1, d))
        for e in range(E):
            mask[e, 0, e * width:(e + 1) * width] = 1.0
        p["w_down"] = p["w_down"] * mask
    elif cfg.n_shared_experts:
        ff_sh = cfg.n_shared_experts * ff
        p["shared"] = {
            "w_gate": rng.standard_normal((d, ff_sh)) / np.sqrt(d),
            "w_up": rng.standard_normal((d, ff_sh)) / np.sqrt(d),
            "w_down": rng.standard_normal((ff_sh, d)) / np.sqrt(ff_sh)}
    return jax.tree.map(lambda a: a.astype(np.float32), p)


def _both(p, x, dtype):
    """(reference tree, port tree, reference x, port x): the router
    stays f32, the rest in ``dtype``."""
    np_dt, t_dt = DTYPES[dtype]

    def cast(path, a):
        keep = path[-1].key == "router"
        return a if keep else a.astype(np_dt)

    ref = jax.tree_util.tree_map_with_path(cast, p)
    port = jax.tree.map(lambda a: torch.from_numpy(
        np.asarray(a, np.float32)).to(torch.float32 if a.dtype == np.float32
                                      else t_dt), ref)
    return (jax.tree.map(jnp.asarray, ref), port,
            jnp.asarray(x.astype(np_dt)), torch.from_numpy(x).to(t_dt))


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _ref(p, x, cfg):
    """The reference's moe_apply, jitted as its serving steps run it."""
    ctx = single_device_ctx()
    return jax.jit(lambda p, x: ref_moe.moe_apply(p, x, cfg, ctx))(p, x)


def _port(p, x, cfg):
    moe.moe_apply.record = []
    try:
        y, aux = moe.moe_apply(p, x, cfg)
        (rec,) = moe.moe_apply.record
    finally:
        moe.moe_apply.record = None
    return y, aux, rec


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _ref_blocks(p, x, cfg):
    """The experts whose output reached each token: [T, E] bool."""
    y, _ = _ref(p, x, cfg)
    y = _np(y).reshape(-1, cfg.n_experts, cfg.d_model // cfg.n_experts)
    return np.abs(y).max(-1) > 0


def _sets(expert_id, mask=None):
    ids = expert_id.numpy()
    mask = np.ones(ids.shape, bool) if mask is None else mask.numpy()
    return [set(row[m].tolist()) for row, m in zip(ids, mask)]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_the_reference(arch, dtype, shape):
    B, S, E = SHAPES[shape]
    ref_cfg, cfg = _cfgs(arch, dtype, E)
    p, tp, x, tx = _both(_layer(cfg, 0), _x(cfg, B, S, 1), dtype)
    want, want_aux = _ref(p, x, ref_cfg)
    got, aux, rec = _port(tp, tx, cfg)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=F32_TOL,
                               atol=F32_TOL)
    if dtype == "float32":
        tol = F32_TOL
    else:
        tol = BF16_REL * float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)
    assert rec["tokens"] == B * S
    if shape == "decode":
        assert moe.capacities(B * S, cfg) == (10, 1)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_ids_and_drops_match_the_reference(arch, shape):
    B, S, E = SHAPES[shape]
    ref_cfg, cfg = _cfgs(arch, "float32", E)
    x = _x(cfg, B, S, 3)
    if shape == "decode":   # tokens 0 and 1 alike: they share their experts
        x[1] = x[0]
    p, tp, x, tx = _both(_layer(cfg, 2, blocks=True), x, "float32")
    chosen = _ref_blocks(p, x, dataclasses.replace(ref_cfg,
                                                   capacity_factor=100.0))
    kept = _ref_blocks(p, x, ref_cfg)
    _, _, rec = _port(tp, tx, cfg)
    ids, port_kept = rec["expert_id"], rec["kept"]
    assert tuple(ids.shape) == (B * S, cfg.top_k)
    assert _sets(ids) == [set(np.flatnonzero(r)) for r in chosen]
    assert _sets(ids, port_kept) == [set(np.flatnonzero(r)) for r in kept]
    dropped = int((chosen & ~kept).sum())
    assert rec["dropped"] == dropped
    if shape == "decode":      # cap_exp 1: an expert keeps its first token
        assert dropped >= cfg.top_k
        for e in range(cfg.n_experts):
            assert int((ids[port_kept] == e).sum()) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_zero_router_takes_the_first_k_experts(arch, dtype):
    """All probabilities tie: the reference's top_k takes experts
    0..k-1 in that order, and so must the port (a stable sort, not
    torch.topk); the capacity then drops the tokens past each window."""
    ref_cfg, cfg = _cfgs(arch, dtype)
    B, S = 4, 3
    layer = _layer(cfg, 4, router_scale=0.0)
    p, tp, x, tx = _both(layer, _x(cfg, B, S, 5), dtype)
    want, want_aux = _ref(p, x, ref_cfg)
    got, aux, rec = _port(tp, tx, cfg)
    k = cfg.top_k
    assert rec["expert_id"].tolist() == [list(range(k))] * (B * S)
    tol = F32_TOL if dtype == "float32" else \
        BF16_REL * float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=F32_TOL)
    _, cap = moe.capacities(B * S, cfg)
    # the first k experts each got all B·S tokens; each keeps cap of them
    assert rec["dropped"] == k * (B * S - min(cap, B * S)) > 0
    blocks = _both(_layer(cfg, 4, blocks=True, router_scale=0.0),
                   _x(cfg, B, S, 5), "float32")
    kept = _ref_blocks(blocks[0], blocks[2], dataclasses.replace(
        ref_cfg, dtype="float32"))
    assert int(kept.sum()) == k * min(cap, B * S)


def test_shared_expert_adds_its_swiglu():
    """kimi-k2's shared expert: the port's output with it, less the
    output without it, is the shared SwiGLU of x; both as the
    reference's."""
    ref_cfg, cfg = _cfgs("kimi-k2-1t-a32b")
    layer = _layer(cfg, 6)
    assert "shared" in layer
    p, tp, x, tx = _both(layer, _x(cfg, 2, 8, 7), "float32")
    with_sh, _, _ = _port(tp, tx, cfg)
    without = {k: v for k, v in tp.items() if k != "shared"}
    no_sh, _, _ = _port(without, tx, cfg)
    want, _ = _ref(p, x, ref_cfg)
    np.testing.assert_allclose(_np(with_sh), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(_np(with_sh - no_sh),
                               _np(TL.ffn_apply(tp["shared"], tx)),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("T", [1, 4, 37, 4096])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"])
def test_capacities_are_the_references_at_m_1(arch, T):
    """cap_send = ceil(T·k·cf), cap_exp = min(ceil(cap_send/E·cf),
    cap_send): the full configs give 1 at a decode step of 4 and 400 at
    a 4 x 1024 prefill (ROADMAP C17)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch) if arch == "qwen3-moe-235b-a22b" else \
        _cfgs(arch)[1]
    k, E, cf = cfg.top_k, cfg.n_experts, cfg.capacity_factor
    cap_send = int(np.ceil(T * k * cf))
    assert moe.capacities(T, cfg) == (
        cap_send, min(int(np.ceil(cap_send / E * cf)), cap_send))
    if arch == "qwen3-moe-235b-a22b" and T == 4:
        assert moe.capacities(T, cfg) == (40, 1)
    if arch == "qwen3-moe-235b-a22b" and T == 4096:
        assert moe.capacities(T, cfg) == (40960, 400)


def test_moe_init_matches_the_reference_tree_and_statistics():
    ref_cfg, cfg = _cfgs("kimi-k2-1t-a32b", "bfloat16")
    ref = jax.tree.map(lambda a: a[0], ref_moe.moe_init(
        jax.random.PRNGKey(0), ref_cfg, 1))
    gen = torch.Generator().manual_seed(0)
    mine = moe.moe_init(gen, cfg)
    shapes = lambda t: jax.tree.map(lambda a: (tuple(a.shape), str(
        a.dtype).replace("torch.", "")), t)
    assert shapes(mine) == shapes(jax.tree.map(np.asarray, ref))
    std = 1.0 / np.sqrt(cfg.d_model)
    w = mine["w_gate"].float()
    assert float(w.abs().max()) <= 3.0 * std * (1 + 2 ** -7)
    assert abs(float(w.std()) / std - 0.9866) < 0.05   # N(0,1) cut at ±3
    assert mine["router"].dtype == torch.float32
    down = mine["w_down"].float()
    assert float(down.abs().max()) <= 3.0 / np.sqrt(cfg.d_ff) * (1 + 2 ** -7)


def test_replay_holds_a_run_to_a_given_routing():
    """``moe_apply.replay``: a run's own routing replayed gives its output
    bit for bit; another routing is used as given, the router's own
    choice and its k-th/(k+1)-th logit gap still recorded."""
    _, cfg = _cfgs("qwen3-moe-235b-a22b", "bfloat16", 16)
    _, tp, _, tx = _both(_layer(cfg, 8), _x(cfg, 4, 5, 9), "bfloat16")
    y, _, rec = _port(tp, tx, cfg)
    moe.moe_apply.replay = [rec["expert_id"].clone()]
    try:
        again, _, rec2 = _port(tp, tx, cfg)
        assert moe.moe_apply.replay == []
        forced = torch.arange(cfg.top_k).repeat(20, 1)
        moe.moe_apply.replay = [forced]
        other, _, rec3 = _port(tp, tx, cfg)
    finally:
        moe.moe_apply.replay = None
    assert torch.equal(again, y) and torch.equal(rec2["kept"], rec["kept"])
    assert torch.equal(rec3["expert_id"], forced)
    assert torch.equal(rec3["own_id"], rec["expert_id"])
    assert not torch.equal(other, y)
    logits = tx.reshape(20, -1).float() @ tp["router"].bfloat16().float()
    top = np.sort(logits.numpy(), axis=-1)[:, ::-1]
    np.testing.assert_allclose(rec["margin"].numpy(),
                               top[:, cfg.top_k - 1] - top[:, cfg.top_k],
                               rtol=1e-6, atol=1e-6)
