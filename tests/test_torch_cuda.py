"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: on a machine without a card every test here skips (the
fixture decides, never the import). On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs are made with numpy from a seed and handed to the kernel (CUDA
tensors) and to the plain version (the same tensors on the CPU).
Integral counts must agree bit for bit; float values within a stated
tolerance. Flash attention (B4): float32 within 2e-5 and bfloat16 within
3e-2 of its plain version, the tolerances ``tests/test_flash_kernel.py``
holds the Pallas kernel to (sums in another order; bf16 outputs rounded
to 8 bits). bf16 at head dims 16, 32 and 64 runs its tensor-core (wgmma)
instance, float32 and hd 8 its CUDA-core (simt) one; the wgmma instance
is also held, output row by output row, within two bf16 ulps of the
row's largest entry (``ROW_TOL``), which a dropped key tile would fail.
"""
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.paper_search import SearchConfig
from repro_torch.core import corpus as corpus_lib
from repro_torch.core.engine import PatternSearchEngine
from repro_torch.kernels import _build, flash_attention as fa, fused, ops
from repro_torch.kernels.sparse_match import sparse_match
from repro_torch.kernels.sparse_match_packed import pack, sparse_match_packed

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda
VOCAB = 256


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _case(seed, sorted_stream=True, Qm=None, L=None):
    """Random ELL docs (pads, duplicates, empty rows, zero values) and a
    merged query stream (in-stream pads, duplicate ids)."""
    rng = np.random.default_rng(seed)
    D = int(rng.integers(1, 700))
    K = int(rng.integers(1, 70))
    Qm = int(rng.integers(0, 300)) if Qm is None else Qm
    L = int(rng.integers(1, 12)) if L is None else L
    ids = np.full((D, K), -1, np.int32)
    vals = np.zeros((D, K), np.float32)
    for d in range(D):
        if rng.random() < 0.1:
            continue
        k = int(rng.integers(1, K + 1))
        row = rng.integers(0, VOCAB, k)
        if k > 1 and rng.random() < 0.3:
            row[0] = row[1]
        ids[d, :k] = np.sort(row)
        vals[d, :k] = rng.integers(0, 30, k)
    mi = np.where(rng.random(Qm) < 0.2, -2,
                  rng.integers(0, VOCAB, Qm)).astype(np.int32)
    mv = np.zeros((Qm, L), np.float32)
    mv[np.arange(Qm), rng.integers(0, L, Qm)] = rng.integers(1, 30, Qm)
    if sorted_stream:
        order = np.argsort(np.where(mi < 0, VOCAB + 1, mi), kind="stable")
        mi, mv = mi[order], mv[order]
    return ids, vals, mi, mv


def _both(dev, *arrays):
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    return cpu, [t.to(dev) for t in cpu]


def test_kernels_build(dev):
    _build.build()
    for name in _build.SOURCES:
        assert _build.library_path(name).exists()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("sorted_stream", [True, False])
def test_ell_and_packed_match_plain_bitwise(dev, seed, sorted_stream):
    ids, vals, mi, mv = _case(seed, sorted_stream)
    (ci, cv, cqi, cqv), (gi, gv, gqi, gqv) = _both(dev, ids, vals, mi, mv)
    want = sparse_match(ci, cv, cqi, cqv)
    got = sparse_match(gi, gv, gqi, gqv).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    words = pack(ids, vals).view(np.int32)
    (cw,), (gw,) = _both(dev, words)
    got_p = sparse_match_packed(gw, gqi, gqv).cpu()
    torch.testing.assert_close(got_p, sparse_match_packed(cw, cqi, cqv),
                               rtol=0, atol=0)


@pytest.mark.parametrize("Qm", [0, 8191, 8192, 20000])
def test_ell_multi_tile_and_empty_streams(dev, Qm):
    """Streams longer than one shared-memory tile (8192 ids) are scored
    tile by tile; an empty stream scores zero."""
    ids, vals, mi, mv = _case(100 + Qm, True, Qm=Qm, L=3)
    (ci, cv, cqi, cqv), (gi, gv, gqi, gqv) = _both(dev, ids, vals, mi, mv)
    got = sparse_match(gi, gv, gqi, gqv).cpu()
    torch.testing.assert_close(got, sparse_match(ci, cv, cqi, cqv),
                               rtol=0, atol=0)


def test_ell_float_values_within_tolerance(dev):
    """Arbitrary float values: the kernel sums each row across lanes in a
    shuffle tree, the plain version in torch's order; both are sums of
    at most K * L products, so rtol 1e-5 with atol 1e-5 x the largest
    |score| bounds the rounding difference."""
    ids, vals, mi, mv = _case(7, True, Qm=400, L=5)
    rng = np.random.default_rng(7)
    vals = (vals * rng.random(vals.shape)).astype(np.float32)
    mv = (mv * rng.standard_normal(mv.shape)).astype(np.float32)
    (ci, cv, cqi, cqv), (gi, gv, gqi, gqv) = _both(dev, ids, vals, mi, mv)
    want = sparse_match(ci, cv, cqi, cqv)
    got = sparse_match(gi, gv, gqi, gqv).cpu()
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("seed", range(6))
def test_fused_matches_plain_bitwise(dev, seed):
    rng = np.random.default_rng(seed)
    nnz_pad = int(rng.integers(1, 40))
    bd = int(2 ** rng.integers(0, 8))
    corpus = corpus_lib.synthesize(int(rng.integers(1, 900)), VOCAB, 12,
                                   nnz_pad, seed=seed)
    tiles, _, _ = fused.tile_stream(fused.corpus_to_stream(corpus),
                                    block_docs=bd, nnz_pad=nnz_pad)
    _, _, mi, mv = _case(seed, bool(seed % 2), L=int(rng.integers(1, 11)))
    qn = np.sqrt((mv ** 2).sum(0) + 1).astype(np.float32)
    kp = int(rng.integers(1, bd + 1))
    (ct, cqi, cqv, cqn), (gt, gqi, gqv, gqn) = _both(
        dev, tiles.view(np.int32), mi, mv, qn)
    wv, wi = fused.fused_match_topk(ct, cqi, cqv, cqn, block_docs=bd, kp=kp)
    gv, gi = fused.fused_match_topk(gt, gqi, gqv, gqn, block_docs=bd, kp=kp)
    torch.testing.assert_close(gv.cpu(), wv, rtol=0, atol=0)
    torch.testing.assert_close(gi.cpu(), wi, rtol=0, atol=0)


def test_wrappers_count_launches_and_reject_bad_inputs(dev):
    ids, vals, mi, mv = _case(3, True)
    _, (gi, gv, gqi, gqv) = _both(dev, ids, vals, mi, mv)
    before = sparse_match.launches
    sparse_match(gi, gv, gqi, gqv)
    assert sparse_match.launches == before + 1
    strided = torch.full((6, 4), -1, dtype=torch.int32, device=dev).t()
    with pytest.raises(ValueError, match="contiguous"):
        sparse_match(strided, torch.zeros(4, 6, device=dev), gqi, gqv)
    with pytest.raises(ValueError, match="one CUDA device"):
        sparse_match(gi, gv.cpu(), gqi, gqv)
    with pytest.raises(TypeError):
        sparse_match(gi.long(), gv, gqi, gqv)


@pytest.mark.parametrize("L", [1, 3, 8])
def test_engine_backends_bit_identical_on_card(dev, L):
    cfg = SearchConfig(name="card-test", vocab_size=2000, avg_nnz_per_doc=20,
                       nnz_pad=32, top_k=8, block_docs=32, block_query=64)
    corpus = corpus_lib.synthesize(3000, cfg.vocab_size, 20, cfg.nnz_pad,
                                   seed=L)
    rng = np.random.default_rng(L)
    idx = rng.integers(0, corpus.n_docs, L)
    qs = [corpus_lib.make_query(corpus, int(i), cfg.max_query_nnz)
          for i in idx]
    qi = np.stack([q[0] for q in qs])
    qv = np.stack([q[1] for q in qs])
    ref = PatternSearchEngine(corpus, cfg, "cpu", "torch").search_typed(
        _query(qi, qv))
    for backend in ops.BACKENDS:
        got = PatternSearchEngine(corpus, cfg, dev, backend).search_typed(
            _query(qi, qv))
        np.testing.assert_array_equal(got.doc_ids, ref.doc_ids, backend)
        np.testing.assert_array_equal(got.scores, ref.scores, backend)
    np.testing.assert_array_equal(ref.doc_ids[:, 0], idx)


def _query(qi, qv):
    from repro_torch.serve import Query
    return Query(qi, qv)


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _attn_inputs(seed, q_shape, kv_shape, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dtype) for s in (q_shape, kv_shape, kv_shape)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (BH, S, hd, causal): tests/test_flash_kernel.py's, then S that no
    # 64-row tile divides, at qwen2's head dim
    (2, 64, 16, True), (1, 128, 32, True), (3, 48, 8, False),
    (2, 96, 16, True), (2, 100, 64, True), (1, 130, 64, False)])
def test_flash_attention_matches_plain(dev, case, dtype):
    BH, S, hd, causal = case
    cpu = _attn_inputs(S + hd, (BH, S, hd), (BH, S, hd), dtype)
    want = fa.flash_attention(*cpu, causal=causal)
    got = fa.flash_attention(*(t.to(dev) for t in cpu), causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.is_cuda
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gqa_at_the_qwen2_prefill_shape(dev, dtype):
    q, k, v = (t.to(dev) for t in _attn_inputs(
        0, (4, 1024, 14, 64), (4, 1024, 2, 64), dtype))
    before = fa.flash_attention_gqa.launches
    got = fa.flash_attention_gqa(q, k, v)
    assert fa.flash_attention_gqa.launches == before + 1
    want = fa.flash_attention_gqa_plain(q, k, v)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_flash_attention_reads_strided_heads(dev):
    B, S, H, KV, hd = 2, 200, 14, 2, 64
    packed = torch.randn(B, S, H + 2 * KV, hd, device=dev,
                         generator=torch.Generator(dev).manual_seed(0))
    q, k, v = packed[:, :, :H], packed[:, :, H:H + KV], packed[:, :, H + KV:]
    got = fa.flash_attention_gqa(q, k, v)
    want = fa.flash_attention_gqa(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="contiguous head_dim"):
        fa.flash_attention_gqa(q.transpose(2, 3).contiguous().transpose(2, 3),
                               k, v)
    with pytest.raises(ValueError, match="head_dim 24"):
        fa.flash_attention(*(torch.zeros(2, 8, 24, device=dev)
                             for _ in range(3)))


def test_lm_smoke_on_the_card_matches_the_cpu(dev):
    """The smoke qwen2 in f32: prefill logits on the card (kernel B4 in
    every layer) within 1e-4 of the CPU's (plain attention; matmuls on
    the card sum in other orders), one B4 launch a layer."""
    import dataclasses
    from repro_torch.configs import qwen2_0p5b
    from repro_torch.models import model as M
    cfg = dataclasses.replace(qwen2_0p5b.smoke_config(), dtype="float32")
    params = M.init(cfg, seed=0, device="cpu")
    on_card = {"embed": {k: t.to(dev) for k, t in params["embed"].items()},
               "final_norm": params["final_norm"].to(dev),
               "blocks": [{g: ({k: t.to(dev) for k, t in v.items()}
                               if isinstance(v, dict) else v.to(dev))
                           for g, v in b.items()} for b in params["blocks"]]}
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32))
    want, _, _ = M.apply_prefill(params, cfg, {"tokens": tokens})
    before = fa.flash_attention_gqa.launches
    got, _, _ = M.apply_prefill(on_card, cfg, {"tokens": tokens.to(dev)})
    assert fa.flash_attention_gqa.launches == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# kernel and plain round the same f32 sums, taken in another order, to
# bf16: an entry may part by one ulp of itself, at most 2^-7 of its row's
# largest entry; the limit is two such ulps
ROW_TOL = 2.0 ** -6


def _row_scaled_err(got, want):
    """max over output rows (the last dim) of max |got - want| over the
    row's max |want|."""
    err = (got.float() - want.float()).abs().amax(-1)
    return float((err / want.float().abs().amax(-1).clamp_min(1e-30)).max())


def _gqa_on_card(dev, seed, B, S, H, KV, hd, dtype=torch.bfloat16):
    return [t.to(dev) for t in _attn_inputs(
        seed, (B, S, H, hd), (B, S, KV, hd), dtype)]


@pytest.mark.parametrize("group", [1, 2, 7])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [64, 100, 130, 1000, 1024])
@pytest.mark.parametrize("hd", fa.WGMMA_HEAD_DIMS)
def test_wgmma_instance_matches_plain(dev, hd, S, causal, group):
    """bf16 on the tensor cores against the plain version (run on the
    card, the same tensors) within 3e-2: whole tiles, S that no 64-row
    tile divides, one to seven query heads a kv head."""
    KV = 2
    q, k, v = _gqa_on_card(dev, S + hd + group, 2, S, KV * group, KV, hd)
    before = dict(fa.flash_attention_gqa.launches_by_design)
    got = fa.flash_attention_gqa(q, k, v, causal=causal)
    after = fa.flash_attention_gqa.launches_by_design
    assert after["wgmma"] == before["wgmma"] + 1
    assert after["simt"] == before["simt"]
    want = fa.flash_attention_gqa_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)
    assert _row_scaled_err(got, want) <= ROW_TOL


@pytest.mark.parametrize("hd", fa.WGMMA_HEAD_DIMS)
def test_wgmma_instance_reads_strided_heads(dev, hd):
    """q, k, v as views of one packed projection give bit for bit what
    their contiguous copies give, and agree with the plain version."""
    B, S, H, KV = 2, 200, 14, 2
    rng = np.random.default_rng(hd)
    packed = torch.from_numpy(rng.standard_normal(
        (B, S, H + 2 * KV, hd)).astype(np.float32)).to(dev).bfloat16()
    q, k, v = packed[:, :, :H], packed[:, :, H:H + KV], packed[:, :, H + KV:]
    assert not q.is_contiguous()
    got = fa.flash_attention_gqa(q, k, v)
    want = fa.flash_attention_gqa(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    want = fa.flash_attention_gqa_plain(q, k, v)
    torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)
    assert _row_scaled_err(got, want) <= ROW_TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", fa.WGMMA_HEAD_DIMS)
def test_wgmma_instance_through_the_bh_entry_point(dev, hd, causal):
    cpu = _attn_inputs(hd, (3, 130, hd), (3, 130, hd), torch.bfloat16)
    before = fa.flash_attention_gqa.launches_by_design["wgmma"]
    got = fa.flash_attention(*(t.to(dev) for t in cpu), causal=causal)
    assert fa.flash_attention_gqa.launches_by_design["wgmma"] == before + 1
    want = fa.flash_attention(*cpu, causal=causal)
    torch.testing.assert_close(got.cpu(), want, rtol=3e-2, atol=3e-2)
    assert _row_scaled_err(got.cpu(), want) <= ROW_TOL


def test_wgmma_instance_refuses_misaligned_views(dev):
    q, k, v = _gqa_on_card(dev, 0, 1, 64, 2, 1, 16)
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=dev)
    shifted = flat[1:].view(q.shape)               # 2 bytes off 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_gqa(shifted, k, v)


def test_flash_attention_library_holds_hgmma(dev):
    """The built library's SASS holds Hopper's warpgroup MMA (HGMMA):
    the bf16 instance really runs on the tensor cores."""
    _build.build(["flash_attention"])
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True).stdout
    assert "HGMMA" in sass


def test_qwen2_prefill_shape_counts_under_wgmma(dev):
    """At the prefill shape, bf16 counts under wgmma and f32 under simt;
    every launch also counts in ``launches``."""
    by = fa.flash_attention_gqa.launches_by_design
    for dtype, which in ((torch.bfloat16, "wgmma"), (torch.float32, "simt")):
        q, k, v = _gqa_on_card(dev, 1, 4, 1024, 14, 2, 64, dtype)
        assert fa.design(dtype, 64) == which
        before, total = dict(by), fa.flash_attention_gqa.launches
        fa.flash_attention_gqa(q, k, v)
        torch.cuda.synchronize()
        assert by[which] == before[which] + 1
        assert sum(by.values()) == sum(before.values()) + 1
        assert fa.flash_attention_gqa.launches == total + 1
