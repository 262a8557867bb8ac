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
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.paper_search import SearchConfig
from repro_torch.core import corpus as corpus_lib
from repro_torch.core.engine import PatternSearchEngine
from repro_torch.kernels import _build, flash_attention as fa, fused, ops
from repro_torch.kernels import sparse_match as sparse_match_mod
from repro_torch.kernels import sparse_match_packed as sparse_match_packed_mod
from repro_torch.kernels.sparse_match import (query_tile_bytes, query_tiles,
                                              sparse_match)
from repro_torch.kernels.sparse_match_packed import pack, sparse_match_packed

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda
VOCAB = 256


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _case(seed, sorted_stream=True, Qm=None, L=None, vocab=VOCAB):
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
        row = rng.integers(0, vocab, k)
        if k > 1 and rng.random() < 0.3:
            row[0] = row[1]
        ids[d, :k] = np.sort(row)
        vals[d, :k] = rng.integers(0, 30, k)
    mi = np.where(rng.random(Qm) < 0.2, -2,
                  rng.integers(0, vocab, Qm)).astype(np.int32)
    mv = np.zeros((Qm, L), np.float32)
    mv[np.arange(Qm), rng.integers(0, L, Qm)] = rng.integers(1, 30, Qm)
    if sorted_stream:
        order = np.argsort(np.where(mi < 0, vocab + 1, mi), kind="stable")
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


# -- B1, B2 and B3 on the hashed query table: every stream shape it sees
PACKED_MAX_KEY = (1 << 20) - 1       # the largest id a packed word carries
KERNELS = ["ell", "packed", "fused"]


def _ell_bitwise(dev, ids, vals, mi, mv):
    (ci, cv, cqi, cqv), (gi, gv, gqi, gqv) = _both(dev, ids, vals, mi, mv)
    want = sparse_match(ci, cv, cqi, cqv)
    got = sparse_match(gi, gv, gqi, gqv).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    return want


def _packed_bitwise(dev, ids, vals, mi, mv):
    words = pack(ids, vals).view(np.int32)
    (cw, cqi, cqv), (gw, gqi, gqv) = _both(dev, words, mi, mv)
    want = sparse_match_packed(cw, cqi, cqv)
    got = sparse_match_packed(gw, gqi, gqv).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    return want


def _fused_tiles(seed, vocab=VOCAB, nnz_pad=None, bd=None, n_docs=None,
                 avg_nnz=12):
    rng = np.random.default_rng(seed)
    nnz_pad = int(rng.integers(1, 40)) if nnz_pad is None else nnz_pad
    bd = int(2 ** rng.integers(0, 8)) if bd is None else bd
    n_docs = int(rng.integers(1, 900)) if n_docs is None else n_docs
    corpus = corpus_lib.synthesize(n_docs, vocab, avg_nnz, nnz_pad,
                                   seed=seed)
    tiles, _, _ = fused.tile_stream(fused.corpus_to_stream(corpus),
                                    block_docs=bd, nnz_pad=nnz_pad)
    return tiles, bd


def _fused_bitwise(dev, tiles, bd, mi, mv, kp=None):
    kp = min(bd, 16) if kp is None else kp
    qn = np.sqrt((mv ** 2).sum(0) + 1).astype(np.float32)
    (ct, cqi, cqv, cqn), (gt, gqi, gqv, gqn) = _both(
        dev, tiles.view(np.int32), mi, mv, qn)
    wv, wi = fused.fused_match_topk(ct, cqi, cqv, cqn, block_docs=bd, kp=kp)
    gv, gi = fused.fused_match_topk(gt, gqi, gqv, gqn, block_docs=bd, kp=kp)
    torch.testing.assert_close(gv.cpu(), wv, rtol=0, atol=0)
    torch.testing.assert_close(gi.cpu(), wi, rtol=0, atol=0)
    return wv, wi


def _match_bitwise(dev, kernel, ids, vals, mi, mv, tiles=None, kp=None):
    """``kernel`` (B1 "ell", B2 "packed" or B3 "fused", on the fused
    ``tiles``) against its plain version, bit for bit; returns a plain
    result."""
    if kernel == "ell":
        return _ell_bitwise(dev, ids, vals, mi, mv)
    if kernel == "packed":
        return _packed_bitwise(dev, ids, vals, mi, mv)
    return _fused_bitwise(dev, *tiles, mi, mv, kp=kp)[0]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("L", [1, 3, 8, 13])
@pytest.mark.parametrize("Qm", [0, 8191, 8192, 20000])
def test_match_kernels_stream_shapes_bitwise(dev, Qm, L, kernel):
    """Empty streams, one query tile, exactly one, and three (tables
    rebuilt tile by tile); L = 13 runs two column passes."""
    seed = 300 + Qm + L
    ids, vals, mi, mv = _case(seed, True, Qm=Qm, L=L)
    _match_bitwise(dev, kernel, ids, vals, mi, mv, _fused_tiles(seed))


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("seed", range(3))
def test_match_kernels_unsorted_streams_bitwise(dev, seed, kernel):
    """A stream out of key order builds no table: the full-tile scan."""
    Qm = [300, 8192, 9000][seed]
    ids, vals, mi, mv = _case(400 + seed, False, Qm=Qm, L=5)
    assert not all(t["sorted"] for t in query_tiles(mi, PACKED_MAX_KEY))
    _match_bitwise(dev, kernel, ids, vals, mi, mv, _fused_tiles(400 + seed))


@pytest.mark.parametrize("kernel", KERNELS)
def test_match_kernels_long_runs_of_one_id_bitwise(dev, kernel):
    """One id carried by 500 items across every column, and 40 times
    within one column; a run walks in stream order."""
    L = 6
    ids, vals, _, _ = _case(7, True, Qm=0, L=L)
    rng = np.random.default_rng(7)
    mi = np.concatenate([np.full(500, 5), np.full(40, 9),
                         rng.integers(0, VOCAB, 300), np.full(60, -2)])
    mv = np.zeros((mi.size, L), np.float32)
    mv[np.arange(mi.size), rng.integers(0, L, mi.size)] = rng.integers(
        1, 30, mi.size)
    mv[500:540] = 0
    mv[500:540, 2] = rng.integers(1, 30, 40)
    order = np.argsort(np.where(mi < 0, VOCAB + 1, mi), kind="stable")
    mi, mv = mi[order].astype(np.int32), mv[order]
    want = _match_bitwise(dev, kernel, ids, vals, mi, mv,
                          _fused_tiles(7, bd=32))
    assert want.abs().sum() > 0


@pytest.mark.parametrize("sorted_stream", [True, False])
def test_uncarried_query_ids_never_match(dev, sorted_stream):
    """Query ids no doc word can carry (2^20 and above for packed words,
    above 2^19 - 1 for fused ones), some equal to a carried id in their
    low bits, mixed with pads: they stay out of the table and match
    nothing."""
    ids, vals, mi, mv = _case(11, sorted_stream, Qm=600, L=4)
    rng = np.random.default_rng(11)
    for high in (1 << 20, 1 << 19):
        q = mi.copy()
        pick = rng.random(q.size) < 0.4
        q[pick] = np.where(rng.random(pick.sum()) < 0.5, high,
                           high + 5000) + rng.integers(0, VOCAB, pick.sum())
        q[rng.random(q.size) < 0.1] = np.iinfo(np.int32).max
        if sorted_stream:
            key = np.where(q < 0, 1 << 40, q.astype(np.int64))
            order = np.argsort(key, kind="stable")
            q, v = q[order].astype(np.int32), mv[order]
        else:
            q, v = q.astype(np.int32), mv
        assert query_tiles(q, PACKED_MAX_KEY)[0]["sorted"] == sorted_stream
        _packed_bitwise(dev, ids, vals, q, v)
        tiles, bd = _fused_tiles(11, bd=16)
        _fused_bitwise(dev, tiles, bd, q, v)


@pytest.mark.parametrize("kernel,bd,kp", [("ell", 0, 0), ("packed", 0, 0),
                                          ("fused", 8, 8), ("fused", 64, 16)])
def test_query_tile_of_8192_distinct_ids(dev, kernel, bd, kp):
    """8192 distinct ids in one tile: the table at its largest (16384
    slots), every slot chain as long as it gets."""
    vocab = 20000
    ids, vals, _, _ = _case(13, True, Qm=0, L=3, vocab=vocab)
    rng = np.random.default_rng(13)
    mi = np.sort(rng.choice(vocab, 8192, replace=False)).astype(np.int32)
    mv = np.zeros((8192, 3), np.float32)
    mv[np.arange(8192), rng.integers(0, 3, 8192)] = rng.integers(1, 30, 8192)
    assert query_tiles(mi, PACKED_MAX_KEY) == [{
        "items": 8192, "sorted": True, "real": 8192, "distinct": 8192,
        "slots": 16384, "sum_cols": 0}]
    tiles = (_fused_tiles(13, vocab=vocab, bd=bd, n_docs=700, avg_nnz=30,
                          nnz_pad=40) if kernel == "fused" else None)
    want = _match_bitwise(dev, kernel, ids, vals, mi, mv, tiles, kp=kp)
    assert want.abs().sum() > 0


def test_fused_crafted_tiles_bitwise(dev):
    """Pads between rows and inside them, an all-pad tile, a tile with
    more headers than block_docs (the rows past it drop), and a full tile
    with no pad at all."""
    bd, nnz_pad = 8, 6
    cap = bd * (1 + nnz_pad)
    pad = np.uint32(0xFFFFFFFF)
    rng = np.random.default_rng(17)

    def row(doc, n=None):
        n = int(rng.integers(0, 4)) if n is None else n
        words = (rng.choice(40, n, replace=False).astype(np.uint32) << 12) \
            | rng.integers(1, 30, n).astype(np.uint32)
        return [np.uint32(0x80000000 | doc)] + list(words)

    gaps = []
    for d in range(5):
        gaps += [pad] * int(rng.integers(0, 3)) + row(d)
        if len(gaps) > 3:
            gaps.insert(len(gaps) - 1, pad)
    many = sum((row(100 + d) for d in range(bd + 3)), [])
    tiles = np.full((4, cap), pad, np.uint32)
    tiles[0, :len(gaps)] = gaps
    tiles[2, :len(many)] = many
    tiles[3] = sum((row(200 + d, nnz_pad) for d in range(bd)), [])
    mi = np.concatenate([np.arange(0, 40, 2), np.full(4, -2)])
    mv = np.ones((mi.size, 3), np.float32)
    wv, wi = _fused_bitwise(dev, tiles, bd, mi.astype(np.int32), mv)
    assert (wi[1] == -1).all() and torch.isinf(wv[1]).all()
    assert set(wi[2].flatten().tolist()) <= set(range(100, 100 + bd)) | {-1}


@pytest.mark.parametrize("nnz_pad,bd,kp", [(312, 128, 16), (1000, 64, 16),
                                            (6, 3, 3), (20, 1024, 40)])
def test_fused_tiles_of_any_size_bitwise(dev, nnz_pad, bd, kp):
    """A 160 KB tile (one stage fits, two do not), a 256 KB one (read
    from device memory), tiles of 21 words (most not on a 16-byte
    boundary: the bulk copy's edges), and 1024 rows a tile (more than
    four a lane: the epilogue rescans shared memory) with kp > 32."""
    vocab = 2000
    _, _, mi, mv = _case(19, True, Qm=900, L=8, vocab=vocab)
    tiles, bd = _fused_tiles(19, vocab=vocab, nnz_pad=nnz_pad, bd=bd,
                             n_docs=300, avg_nnz=max(2, nnz_pad // 2))
    _fused_bitwise(dev, tiles, bd, mi, mv, kp=kp)


def test_fused_stage_rule(dev):
    """One tile stage wherever it fits a block (the main shape's 66 KB,
    small tiles, a 160 KB tile), none for a tile too big for one; -1
    where even the unstaged launch would not fit."""
    stages = _build.kernel("fused", "fused_match_topk_stages",
                           [ctypes.c_int] * 4 + [ctypes.c_longlong])
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    assert stages(16512, 128, 4096, 8, optin) == 1
    assert stages(21, 3, 900, 8, optin) == 1
    assert stages(128 * 313, 128, 4096, 8, optin) == 1
    assert stages(64 * 1001, 64, 4096, 8, optin) == 0
    assert stages(16512, 128, 4096, 8, 1024) == -1


LONG_QUERY_ITEMS = [700, 1500, 3000, 4096, 8000]


def _long_stream(seed, n_real, L, vocab):
    """n_real real items of one sorted tile, in a 4096- or 8192-item
    bucket: the merged stream of L queries of ~n_real / L ids each."""
    rng = np.random.default_rng(seed)
    Qm = 4096 if n_real <= 4096 else 8192
    mi = np.full(Qm, -2, np.int32)
    mi[:n_real] = np.sort(rng.integers(0, vocab, n_real))
    mv = np.zeros((Qm, L), np.float32)
    mv[np.arange(n_real), rng.integers(0, L, n_real)] = rng.integers(
        1, 30, n_real)
    return mi, mv


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("L", [8, 13])
@pytest.mark.parametrize("n_real", LONG_QUERY_ITEMS)
def test_match_kernels_long_queries_bitwise(dev, n_real, L, kernel):
    """Longer queries than the main path's: B1's and B2's run sums narrow
    to 4 columns a pass as the real items grow, and then their hits walk
    their runs; B3's sums fit at 8 columns or not at all."""
    vocab = 20000
    ids, vals, _, _ = _case(31, True, Qm=0, L=L, vocab=vocab)
    mi, mv = _long_stream(31 + n_real, n_real, L, vocab)
    want = _match_bitwise(dev, kernel, ids, vals, mi, mv, _fused_tiles(
        31, vocab=vocab, bd=64, n_docs=700, avg_nnz=30, nnz_pad=40))
    assert want.abs().sum() > 0


@pytest.mark.parametrize("L", [8, 13])
@pytest.mark.parametrize("n_real", LONG_QUERY_ITEMS)
def test_ell_float_values_long_queries_within_tolerance(dev, n_real, L):
    """Float doc values and float query values at the long-query
    lengths: B1's narrow passes and its run walks with floats, within
    the tolerance of test_ell_float_values_within_tolerance."""
    vocab = 20000
    ids, vals, _, _ = _case(37, True, Qm=0, L=L, vocab=vocab)
    mi, mv = _long_stream(37 + n_real, n_real, L, vocab)
    rng = np.random.default_rng(37 + n_real)
    vals = (vals * rng.random(vals.shape)).astype(np.float32)
    mv = (mv * rng.standard_normal(mv.shape)).astype(np.float32)
    (ci, cv, cqi, cqv), (gi, gv, gqi, gqv) = _both(dev, ids, vals, mi, mv)
    want = sparse_match(ci, cv, cqi, cqv)
    got = sparse_match(gi, gv, gqi, gqv).cpu()
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("sorted_stream", [True, False])
def test_ell_ids_at_and_above_2_20_match_exactly(dev, sorted_stream):
    """B1 holds every non-negative id in its table, unlike B2 and B3:
    doc and query ids of 2^20 and above, up to 2^31 - 1, with low bits
    that equal small ids, mixed with small ids and pads, match exactly
    as the plain version says."""
    ids, vals, mi, mv = _case(41, sorted_stream, Qm=900, L=6)
    rng = np.random.default_rng(41)
    big = np.sort(np.concatenate([
        [1 << 20, (1 << 20) + 1, (1 << 31) - 2, (1 << 31) - 1],
        ((rng.choice(2000, VOCAB - 4, replace=False) + 1) << 20)
        + rng.integers(0, VOCAB, VOCAB - 4)]))
    big = np.where(np.arange(VOCAB) % 3 == 1, np.arange(VOCAB), big)
    remap = lambda a: np.where(a < 0, a, big[np.maximum(a, 0)]).astype(
        np.int32)
    ids, mi = remap(ids), remap(mi)
    mi[0] = (1 << 31) - 1
    ids[np.flatnonzero((ids >= 0).any(1))[0], 0] = (1 << 31) - 1
    if sorted_stream:
        key = np.where(mi < 0, 1 << 40, mi.astype(np.int64))
        order = np.argsort(key, kind="stable")
        mi, mv = mi[order], mv[order]
    (plan,) = query_tiles(mi, sparse_match_mod.MAX_KEY)
    assert plan["sorted"] == sorted_stream
    want = _ell_bitwise(dev, ids, vals, mi, mv)
    assert want.abs().sum() > 0


def test_ell_value_that_is_not_finite_scores_nan_on_a_miss(dev):
    """A real slot's inf or NaN value adds NaN where its id misses (value
    x 0), as the plain version does; pads add nothing."""
    ids, vals, mi, mv = _case(43, True, Qm=300, L=4)
    real = np.argwhere(ids >= 0)
    pick = real[np.random.default_rng(43).random(len(real)) < 0.05]
    vals[pick[::2, 0], pick[::2, 1]] = np.inf
    vals[pick[1::2, 0], pick[1::2, 1]] = np.nan
    vals[ids < 0] = np.inf
    (ci, cv, cqi, cqv), (gi, gv, gqi, gqv) = _both(dev, ids, vals, mi, mv)
    want = sparse_match(ci, cv, cqi, cqv)
    got = sparse_match(gi, gv, gqi, gqv).cpu()
    assert want.isnan().any() and want.isfinite().any()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("kernel", ["ell", "packed"])
def test_query_tile_takes_what_registers_leave(dev, kernel):
    """B1's and B2's query tiles take more than their least where their
    registers leave shared memory, and the long-query test above then
    covers run sums of 8 columns, of 4, and none."""
    mod = sparse_match_mod if kernel == "ell" else sparse_match_packed_mod
    max_key = sparse_match_mod.MAX_KEY if kernel == "ell" else PACKED_MAX_KEY
    tile = {Qm: mod.tile_bytes(dev, Qm, 8) for Qm in (4096, 8192)}
    assert tile[4096] > query_tile_bytes(4096)
    assert tile[8192] >= query_tile_bytes(8192)
    widths = set()
    for n_real in LONG_QUERY_ITEMS:
        mi, _ = _long_stream(31 + n_real, n_real, 8, 20000)
        (plan,) = query_tiles(mi, max_key,
                              min_cols=sparse_match_mod.MIN_PASS_COLS,
                              tile_bytes=tile[mi.size])
        widths.add(plan["sum_cols"])
    assert widths == {8, 4, 0}


def test_packed_float_queries_within_tolerance(dev):
    """Float query values: a lane sums its four slots in order and the
    lanes by a shuffle tree, the plain version in torch's order; both are
    sums of at most K * L products, so B1's tolerance holds (rtol 1e-5,
    atol 1e-5 x the largest |score|)."""
    ids, vals, mi, mv = _case(23, True, Qm=400, L=8)
    mv = (mv * np.random.default_rng(23).standard_normal(mv.shape)).astype(
        np.float32)
    words = pack(ids, vals).view(np.int32)
    (cw, cqi, cqv), (gw, gqi, gqv) = _both(dev, words, mi, mv)
    want = sparse_match_packed(cw, cqi, cqv)
    got = sparse_match_packed(gw, gqi, gqv).cpu()
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


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
