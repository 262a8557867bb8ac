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
to 8 bits). bf16 at head dims 16 to 256 runs its tensor-core (wgmma)
instance, float32 and hd 8 its CUDA-core (simt) one, each with and
without a sliding window, and each at keys of their own length (Sk != S,
non-causal: cross-attention); the wgmma instance
is also held, output row by output row, within two bf16 ulps of the
row's largest entry (``ROW_TOL``), which a dropped key tile would fail.
"""
import ctypes
import subprocess
import threading
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


# ---------------------------------------------------------------------------
# the storage tier on the card: FlashSearchSession, shared slab cache,
# approx pools, AutoTiling's tiles
# ---------------------------------------------------------------------------
STORE_CFG = SearchConfig(name="store-card", vocab_size=4096,
                         avg_nnz_per_doc=40, nnz_pad=64, top_k=8,
                         block_docs=128, block_query=512)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from repro_torch.storage import FlashStore
    cfg = STORE_CFG
    corpus = corpus_lib.synthesize(3000, cfg.vocab_size, cfg.avg_nnz_per_doc,
                                   cfg.nnz_pad, seed=21)
    root = str(tmp_path_factory.mktemp("card") / "store")
    st = FlashStore.create(root, vocab_size=cfg.vocab_size,
                           docs_per_segment=700)
    st.append_corpus(corpus)
    rng = np.random.default_rng(4)
    requests = []
    for L in (1, 3, 8):
        idx = rng.integers(0, corpus.n_docs, L)
        qs = [corpus_lib.make_query(corpus, int(i), cfg.max_query_nnz)
              for i in idx]
        requests.append((idx, np.stack([q[0] for q in qs]),
                         np.stack([q[1] for q in qs])))
    return root, corpus, requests


def _same_result(a, b):
    np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
    np.testing.assert_array_equal(a.scores.view(np.uint32),
                                  b.scores.view(np.uint32))


@pytest.mark.parametrize("backend", ["gpu", "gpu_packed", "gpu_fused",
                                     "torch"])
def test_store_session_on_the_card_matches_the_resident_engine(dev, store,
                                                                backend):
    from repro_torch.serve import Query
    from repro_torch.storage import FlashSearchSession, FlashStore
    root, corpus, requests = store
    counter = {"gpu": sparse_match, "gpu_packed": sparse_match_packed,
               "gpu_fused": fused.fused_match_topk}.get(backend)
    before = counter.launches if counter else 0
    resident = PatternSearchEngine(corpus, STORE_CFG, dev, backend)
    with FlashSearchSession(FlashStore.open(root), STORE_CFG, dev,
                            backend) as sess:
        for n, (idx, qi, qv) in enumerate(requests + requests):
            got = sess.search_typed(Query(qi, qv))
            _same_result(got, resident.search_typed(Query(qi, qv)))
            np.testing.assert_array_equal(got.doc_ids[:, 0], idx)
            st = sess.last_stats
            assert st.docs_scored == corpus.n_docs
            # the first request is cold, every later one warm
            assert (st.cache_misses if n == 0 else
                    st.cache_hits) == st.segments_scored
    if counter:
        assert counter.launches > before


def test_gpu_and_gpu_packed_share_one_slab_cache_on_the_card(dev, store):
    """ROADMAP C11 on the card: sessions of every backend on one cache,
    each answering as its own resident engine does."""
    from repro_torch.serve import Query
    from repro_torch.storage import FlashSearchSession, FlashStore, SlabCache
    root, corpus, requests = store
    fs = FlashStore.open(root)
    cache = SlabCache()
    backends = ("gpu", "gpu_packed", "gpu_fused", "torch")
    sessions = {b: FlashSearchSession(fs, STORE_CFG, dev, b,
                                      slab_cache=cache) for b in backends}
    try:
        for _ in range(2):
            for b, sess in sessions.items():
                eng = PatternSearchEngine(corpus, STORE_CFG, dev, b)
                for _, qi, qv in requests:
                    _same_result(sess.search_typed(Query(qi, qv)),
                                 eng.search_typed(Query(qi, qv)))
        # ELL (gpu and torch), packed and fused slabs of every segment
        assert len(cache) == 3 * fs.n_segments
    finally:
        for sess in sessions.values():
            sess.close()


@pytest.mark.parametrize("backend", ["gpu", "gpu_packed", "gpu_fused"])
def test_approx_pools_of_8_to_65536_docs_match_the_plain_versions(dev,
                                                                   backend):
    """The approx tier pads a candidate pool to a power of two (8 to the
    plan's slab): each size, scored on the card, against the same pool
    scored by the plain versions on the CPU."""
    from repro_torch.serve import Query
    cfg = SearchConfig(name="pools")
    corpus = corpus_lib.synthesize(1 << 16, cfg.vocab_size,
                                   cfg.avg_nnz_per_doc, cfg.nnz_pad, seed=5)
    on_card = PatternSearchEngine(None, cfg, dev, backend)
    on_cpu = PatternSearchEngine(None, cfg, "cpu", backend)
    rng = np.random.default_rng(6)
    for n in (8, 64, 512, 4096, 1 << 16):
        rows = np.sort(rng.choice(corpus.n_docs, n - (n > 8), replace=False))
        pool = corpus_lib.Corpus(corpus.doc_ids[rows], corpus.ids[rows],
                                 corpus.vals[rows], corpus.norms[rows]
                                 ).pad_docs_to(n)
        idx = rows[rng.integers(0, rows.size, 8)]
        qs = [corpus_lib.make_query(corpus, int(i), cfg.max_query_nnz)
              for i in idx]
        qi, qv = np.stack([q[0] for q in qs]), np.stack([q[1] for q in qs])
        got = on_card.search_streaming(qi, qv, [on_card.put_slab(pool)])
        want = on_cpu.search_streaming(qi, qv, [on_cpu.put_slab(pool)])
        _same_result(got, want)
        np.testing.assert_array_equal(got.doc_ids[:, 0], idx)


@pytest.mark.parametrize("nnz_pad", [64, 128, 256, 512])
def test_auto_tiling_tiles_are_staged_in_shared_memory(dev, nnz_pad):
    from repro_torch.kernels.tiling import AutoTiling
    for block_docs in (fused.MAX_TILE_ROWS, 128):
        tiling = AutoTiling(block_docs, 512)
        bd = tiling.doc_tile(nnz_pad=nnz_pad, n_docs=1 << 20)
        for Lp in (1, 2, 4, 8, 16):
            for Qm in (Lp * tiling.query_tile(Lp), 8192, 1 << 16):
                assert fused.stages(dev, bd * (1 + nnz_pad), bd, Qm,
                                    Lp) == 1, (bd, Lp, Qm)


# ---------------------------------------------------------------------------
# live ingest and the coalescing service on the card
# ---------------------------------------------------------------------------
def _live_copy(store, tmp_path, n_new=100, seal_docs=32):
    """A copy of the store fixture, and ``n_new`` documents to append
    (ids after the corpus's), self-queries of 2 base documents, 2 that
    will be sealed and 2 that stay in the memtable."""
    import shutil
    root, corpus, _ = store
    live = str(tmp_path / "live")
    shutil.copytree(root, live)
    cfg = STORE_CFG
    new = corpus_lib.synthesize(n_new, cfg.vocab_size, cfg.avg_nnz_per_doc,
                                cfg.nnz_pad, seed=22)
    new.doc_ids[:] += corpus.n_docs
    docs = []
    for r in range(n_new):
        keep = new.ids[r] >= 0
        docs.append((int(new.doc_ids[r]), list(zip(
            new.ids[r][keep].tolist(), new.vals[r][keep].astype(int).tolist()))))
    picks = [(corpus, 5), (corpus, 2999), (new, 0), (new, seal_docs),
             (new, n_new - 2), (new, n_new - 1)]
    qs = [corpus_lib.make_query(c, r, cfg.max_query_nnz) for c, r in picks]
    want = [int(c.doc_ids[r]) for c, r in picks]
    return live, docs, qs, want


@pytest.mark.parametrize("backend", ["gpu", "gpu_packed", "gpu_fused"])
def test_appended_documents_search_on_the_card_as_on_torch(dev, store,
                                                          tmp_path, backend):
    """Appends land in sealed deltas and the memtable; a kernel session
    on the card answers as the ``torch`` gather path does after the WAL
    replays the memtable, launching its kernel once a scored segment and
    once for the memtable."""
    from repro_torch.serve import Query
    from repro_torch.storage import FlashSearchSession, FlashStore
    live, docs, qs, want = _live_copy(store, tmp_path)
    counter = {"gpu": sparse_match, "gpu_packed": sparse_match_packed,
               "gpu_fused": fused.fused_match_topk}[backend]
    batch = Query(np.stack([q[0] for q in qs]), np.stack([q[1] for q in qs]))
    with FlashSearchSession(FlashStore.open(live), STORE_CFG, dev,
                            backend) as sess:
        sess.enable_ingest(seal_docs=32, auto_compact=False)
        for d, p in docs:
            sess.append(d, p)                 # 3 seals, 4 in the memtable
        before = counter.launches
        got = sess.search_typed(batch)
        st = sess.last_stats
        assert counter.launches - before == st.segments_scored + 1
        assert st.memtable_docs == 4
    with FlashSearchSession(FlashStore.open(live), STORE_CFG, dev,
                            "torch") as ref:
        assert ref.enable_ingest(auto_compact=False).stats.replayed == 4
        _same_result(got, ref.search_typed(batch))
    assert list(got.doc_ids[:, 0]) == want


def test_service_over_a_live_gpu_session_equals_serial(dev, store, tmp_path):
    """16 self-queries from 4 threads through ``submit`` on a live gpu
    session: each row equals the serial search of its query."""
    import threading
    from repro_torch.serve import Query
    from repro_torch.storage import FlashSearchSession, FlashStore
    live, docs, qs, want = _live_copy(store, tmp_path)
    qs = qs * 3
    rows = [None] * len(qs)
    with FlashSearchSession(FlashStore.open(live), STORE_CFG, dev,
                            "gpu") as sess:
        sess.enable_ingest(seal_docs=32, auto_compact=False)
        for d, p in docs:
            sess.append(d, p)

        def client(t):
            for i in range(t, len(qs), 4):
                rows[i] = sess.submit(Query(*qs[i])).result(timeout=120)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        for i, (qi, qv) in enumerate(qs):
            serial = sess.search_typed(Query(qi[None], qv[None]))
            np.testing.assert_array_equal(rows[i].doc_ids, serial.doc_ids[0])
            np.testing.assert_array_equal(rows[i].scores.view(np.uint32),
                                          serial.scores[0].view(np.uint32))
        assert sess.service().stats.n_requests == len(qs)
    assert [int(r.doc_ids[0]) for r in rows] == want * 3


# ---------------------------------------------------------------------------
# the cluster tier on the card: threads launching at once
# ---------------------------------------------------------------------------
def test_launch_counts_are_exact_under_four_threads(dev):
    """4 threads x 50 launches of B1: the count is exactly 200."""
    ids, vals, mi, mv = _case(3)
    _, (d_ids, d_vals, q_ids, q_vals) = _both(dev, ids, vals, mi, mv)
    sparse_match(d_ids, d_vals, q_ids, q_vals)          # built, loaded
    sparse_match.launches = 0
    barrier = threading.Barrier(4)

    def launch():
        barrier.wait()
        for _ in range(50):
            sparse_match(d_ids, d_vals, q_ids, q_vals)

    threads = [threading.Thread(target=launch) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert sparse_match.launches == 200


@pytest.fixture(scope="module")
def cluster(store, tmp_path_factory):
    """The store fixture's corpus as 4 shards x 2 replicas."""
    from repro_torch.cluster import build_sharded_store
    _, corpus, requests = store
    root = str(tmp_path_factory.mktemp("card-cluster") / "c4x2")
    build_sharded_store(root, corpus=corpus, n_shards=4, replicas=2,
                        vocab_size=STORE_CFG.vocab_size,
                        docs_per_segment=350).close()
    return root, corpus, requests


_COUNTERS = {"gpu": sparse_match, "gpu_packed": sparse_match_packed,
             "gpu_fused": fused.fused_match_topk}


@pytest.mark.parametrize("backend", ["gpu", "gpu_packed", "gpu_fused"])
def test_cluster_on_the_card_equals_the_cluster_on_torch(dev, cluster,
                                                         backend):
    """Each request cold then warm on the card against the same cluster on
    CPU ``torch``, bit for bit; one launch a scored segment under the
    router's 4 threads; the store-wide resident engine agrees too."""
    from repro_torch.cluster import FlashClusterSession
    from repro_torch.serve import Query
    root, corpus, requests = cluster
    counter = _COUNTERS[backend]
    resident = PatternSearchEngine(corpus, STORE_CFG, dev, backend)
    with FlashClusterSession(root, STORE_CFG, device=dev, backend=backend,
                             max_workers=4) as sess, \
            FlashClusterSession(root, STORE_CFG, device="cpu",
                                backend="torch") as cpu:
        for n, (idx, qi, qv) in enumerate(requests + requests):
            before = counter.launches
            got = sess.search_typed(Query(qi, qv))
            torch.cuda.synchronize()
            st = sess.last_stats
            assert counter.launches - before == st.segments_scored > 0
            assert st.docs_scored == corpus.n_docs
            # the first request is cold, every later one warm
            assert (st.cache_misses if n == 0 else
                    st.cache_hits) == st.segments_scored
            _same_result(got, cpu.search_typed(Query(qi, qv)))
            _same_result(got, resident.search_typed(Query(qi, qv)))
            np.testing.assert_array_equal(got.doc_ids[:, 0], idx)


class _CountedReplica:
    """A replica session that adds up the segments its searches scored
    (a kernel launch each), winners and losers alike, and that waits for
    ``gate`` first while one is set."""

    def __init__(self, inner):
        self._inner = inner
        self.scored = 0
        self.gate = None
        self.done = threading.Event()

    def hold(self, gate):
        self.gate, self.done = gate, threading.Event()

    def search(self, *a, **k):
        if self.gate is not None:
            self.gate.wait()
        try:
            return self._inner.search(*a, **k)
        finally:
            self.scored += self._inner.last_stats.segments_scored
            self.done.set()

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_a_gated_hedge_and_a_partial_gather_on_the_card(dev, cluster):
    """Shard 1's primary waits on an event that opens only after each call
    returns: the hedge to replica 1 wins bit-identically and marks
    nothing; a deadline-bound gather without hedging drops shard 1 and
    equals the merge of the other three. B1 launches once a segment that
    any attempt scored: the winners', which ClusterStats reports, plus
    hedge losers' and the released straggler's."""
    from repro_torch.cluster import FlashClusterSession
    from repro_torch.core.engine import _merge_results
    from repro_torch.serve import HedgePolicy, Query, QueryOptions
    root, corpus, requests = cluster
    _, qi, qv = requests[-1]
    q = Query(qi, qv)
    with FlashClusterSession(root, STORE_CFG, device=dev) as sess:
        router = sess.router
        full = sess.search_typed(q)
        reps = {}
        for s in range(4):
            for r in range(2):
                reps[s, r] = _CountedReplica(router._session(s, r))
                router._sessions[s][r] = reps[s, r]
        torch.cuda.synchronize()
        sparse_match.launches = 0
        # the hedge
        gate = threading.Event()
        reps[1, 0].hold(gate)
        router.hedge_policy = HedgePolicy(fallback_ms=1.0, min_ms=0.0)
        try:
            hedged = sess.search_typed(q)
            st = sess.last_stats
        finally:
            gate.set()
        router._hedge_executor().shutdown(wait=True)
        _same_result(hedged, full)
        assert st.hedges >= 1 and st.hedge_wins >= 1 and not st.partial
        assert reps[1, 0].done.is_set() and reps[1, 1].scored > 0
        assert router.health() == [[True, True]] * 4
        # the partial gather
        router.hedge_policy = None
        gate = threading.Event()
        reps[1, 0].hold(gate)
        try:
            resp = sess.search(q, options=QueryOptions(
                deadline_ms=1000.0, allow_partial=True))
            st = sess.last_stats
        finally:
            gate.set()
        assert reps[1, 0].done.wait(timeout=120)
        assert resp.stats.partial and resp.stats.shards_missing == (1,)
        assert st.partial and st.shards_missing == (1,)
        assert st.per_shard[1] is None
        want = None
        for s in (0, 2, 3):
            part = reps[s, 0].search_typed(q)
            want = part if want is None else _merge_results(
                want, part, STORE_CFG.top_k)
        _same_result(resp.results, want)
        torch.cuda.synchronize()
        # the three direct searches above bypass the counting wrappers
        direct = sum(reps[s, 0]._inner.last_stats.segments_scored
                     for s in (0, 2, 3))
        assert sparse_match.launches == direct + sum(
            r.scored for r in reps.values())


def test_cluster_on_the_card_never_reaches_a_plain_version(dev, cluster,
                                                           monkeypatch):
    """Every kernel's plain version raises: a cluster search on the card
    with hedging armed goes through the kernels alone."""
    from repro_torch.cluster import FlashClusterSession
    from repro_torch.serve import HedgePolicy, Query

    def plain_called(*args, **kwargs):
        raise AssertionError("plain version called on the card")

    root, corpus, requests = cluster
    for backend in ("gpu", "gpu_packed", "gpu_fused"):
        resident = PatternSearchEngine(corpus, STORE_CFG, dev, backend)
        want = [resident.search_typed(Query(qi, qv))
                for _, qi, qv in requests]
        with monkeypatch.context() as m:
            m.setattr(sparse_match_mod, "sparse_match_plain", plain_called)
            m.setattr(sparse_match_packed_mod, "sparse_match_packed_plain",
                      plain_called)
            m.setattr(fused, "fused_match_topk_plain", plain_called)
            with FlashClusterSession(
                    root, STORE_CFG, device=dev, backend=backend,
                    hedge_policy=HedgePolicy(fallback_ms=1.0,
                                             min_ms=0.0)) as sess:
                for (_, qi, qv), w in zip(requests, want):
                    _same_result(sess.search_typed(Query(qi, qv)), w)


# ---------------------------------------------------------------------------
# the live telemetry plane and GraphBLAS on the card
# ---------------------------------------------------------------------------
def _http(url):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_scrapes_stay_200_under_writes_on_the_card(dev, store, tmp_path):
    """/metrics, /healthz, /slo and /debug/traces scraped in a loop while
    4 clients submit to a live gpu session and a writer appends 400
    documents (a seal every 16) until the compactor has folded: every
    answer is 200."""
    import json
    from pathlib import Path
    from repro_torch.obs import Obs
    from repro_torch.obs.slo import SLOMonitor, default_slos
    from repro_torch.serve import Query
    from repro_torch.storage import FlashSearchSession, FlashStore
    live, docs, qs, _ = _live_copy(store, tmp_path, n_new=400, seal_docs=16)
    obs = Obs(trace_sample=1)
    with FlashSearchSession(FlashStore.open(Path(live)), STORE_CFG, dev,
                            "gpu", obs=obs) as sess:
        pipe = sess.enable_ingest(seal_docs=16, compact_poll_s=0.01)
        srv = sess.start_telemetry(slo_monitor=SLOMonitor(
            obs, default_slos("store", latency_ms=250.0)))
        stop = threading.Event()
        codes = []

        def scraper():
            while not stop.is_set():
                for route in ("/metrics", "/healthz", "/slo",
                              "/debug/traces"):
                    code, body = _http(srv.url(route))
                    codes.append((route, code, body[:300]))

        def client(t):
            for i in range(8):
                sess.submit(Query(*qs[(t + i) % 2])).result(timeout=120)

        scrape = threading.Thread(target=scraper, daemon=True)
        scrape.start()
        clients = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in clients:
            t.start()
        try:
            for d, p in docs:
                sess.append(d, p)
            for t in clients:
                t.join(timeout=300)
            for _ in range(600):                # the fold: <= 60 s
                if pipe.stats.compactions >= 1:
                    break
                stop.wait(0.1)
        finally:
            stop.set()
            scrape.join(timeout=120)
        assert not scrape.is_alive()
        assert not any(t.is_alive() for t in clients)
        assert pipe.stats.seals >= 25 and pipe.stats.compactions >= 1
        bad = [c for c in codes if c[1] != 200]
        assert codes and not bad, bad[:3]
        health = json.loads(_http(srv.url("/healthz"))[1])
        assert health["components"]["ingest"]["detail"][0]["root"] == live


def test_profile_capture_on_the_card_holds_a_b1_launch(dev, store, tmp_path,
                                                       capfd):
    """/debug/profile on a gpu session while a thread searches: the trace
    names B1's kernel (``table_kernel`` over ``EllDocs``), holds CPU ops
    of a thread other than the HTTP one, and Kineto prints no
    ``External init callback`` error."""
    import json
    from repro_torch.obs import Obs
    from repro_torch.serve import Query
    from repro_torch.storage import FlashSearchSession, FlashStore
    root, _, requests = store
    _, qi, qv = requests[-1]
    with FlashSearchSession(FlashStore.open(root), STORE_CFG, dev, "gpu",
                            obs=Obs()) as sess:
        srv = sess.start_telemetry(profile_dir=str(tmp_path / "prof"))
        stop, searched = threading.Event(), []

        def load():
            while not stop.is_set():
                searched.append(sess.search_typed(Query(qi, qv)))

        t = threading.Thread(target=load, name="search-load")
        t.start()
        try:
            while not searched:
                stop.wait(0.01)
            code, body = _http(srv.url("/debug/profile?ms=500"))
        finally:
            stop.set()
            t.join(timeout=120)
    assert code == 200, body
    ans = json.loads(body)
    events = json.load(open(ans["file"]))["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    seen = (f"{len(searched)} searches, {len(events)} events, kernels "
            f"{sorted(set(kernels))[:8]}, categories "
            f"{sorted({str(e.get('cat')) for e in events})}")
    assert any("table_kernel" in k and "EllDocs" in k for k in kernels), seen
    assert any(e.get("cat") == "cpu_op" and e.get("tid") != ans["thread"]
               for e in events), seen
    assert "External init callback" not in capfd.readouterr().err


def test_pagerank_and_bfs_on_the_card_equal_the_cpu(dev):
    """A graph of 2^14 vertices and 2^18 edges (in-neighbours uniform
    from seed 0): PageRank on the card within rtol 1e-5 of the same call
    on the CPU (sums in another order), BFS levels exactly, and equal to
    a numpy BFS."""
    from repro_torch.core import graphblas as gb
    n, m = 1 << 14, 1 << 18
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    order = np.argsort(dst, kind="stable")
    indeg = np.bincount(dst, minlength=n)
    ids = np.full((n, indeg.max()), -1, np.int32)
    ids[dst[order], np.arange(m) - np.repeat(np.cumsum(indeg) - indeg,
                                             indeg)] = src[order]
    vals = (ids >= 0).astype(np.float32)
    out_deg = np.bincount(src, minlength=n)
    cpu = [torch.from_numpy(a) for a in (ids, vals, out_deg)]
    card = [a.to(dev) for a in cpu]
    pr = gb.pagerank(*card)
    assert pr.device == dev
    torch.testing.assert_close(pr.cpu(), gb.pagerank(*cpu), rtol=1e-5,
                               atol=0)
    assert abs(float(pr.sum()) - 1.0) < 1e-3
    levels = gb.bfs_levels(card[0], 0, max_iters=32)
    assert torch.equal(levels.cpu(), gb.bfs_levels(cpu[0], 0, max_iters=32))
    want = np.full(n, np.inf, np.float32)
    want[0] = 0
    frontier = np.zeros(n, bool)
    frontier[0] = True
    for d in range(1, 33):
        nxt = np.zeros(n, bool)
        nxt[dst[frontier[src]]] = True
        nxt &= np.isinf(want)
        want[nxt] = d
        frontier = nxt
    np.testing.assert_array_equal(levels.cpu().numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gqa_at_the_qwen3_prefill_shape(dev, dtype):
    """hd 128 at qwen3-4b's prefill shape: bf16 on the wgmma instance (two
    64-column sub-tiles a tile), f32 on the simt one, each within its
    tolerance of the plain version and counted under its instance."""
    q, k, v = _gqa_on_card(dev, 2, 4, 1024, 32, 8, 128, dtype)
    which = fa.design(dtype, 128)
    assert which == ("wgmma" if dtype == torch.bfloat16 else "simt")
    before = dict(fa.flash_attention_gqa.launches_by_design)
    got = fa.flash_attention_gqa(q, k, v)
    after = fa.flash_attention_gqa.launches_by_design
    assert after[which] == before[which] + 1
    want = fa.flash_attention_gqa_plain(q, k, v)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert _row_scaled_err(got, want) <= ROW_TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 64, 100, 130])
def test_simt_instance_at_head_dim_128(dev, S, causal):
    """f32 at hd 128 (128 threads a 64-row tile, 64 accumulators a
    thread) against the plain version on the CPU."""
    cpu = _attn_inputs(S, (2, S, 4, 128), (2, S, 2, 128), torch.float32)
    want = fa.flash_attention_gqa(*cpu, causal=causal)
    before = fa.flash_attention_gqa.launches_by_design["simt"]
    got = fa.flash_attention_gqa(*(t.to(dev) for t in cpu), causal=causal)
    assert fa.flash_attention_gqa.launches_by_design["simt"] == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd", [96, 512])
def test_head_dims_outside_the_kernel_are_refused_on_the_card(dev, hd):
    q, k, v = _gqa_on_card(dev, 0, 1, 64, 2, 1, hd)
    before = dict(fa.flash_attention_gqa.launches_by_design)
    with pytest.raises(ValueError, match=f"head_dim {hd}"):
        fa.flash_attention_gqa(q, k, v)
    assert fa.flash_attention_gqa.launches_by_design == before


# ---------------------------------------------------------------------------
# head dim 256 and the sliding window (gemma3)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [0, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gqa_at_the_gemma3_prefill_shape(dev, dtype, window):
    """hd 256 at gemma3-4b's prefill shape (B 4, S 2048, 8 heads over 4),
    global and with its local layers' window of 1024: bf16 on the wgmma
    instance (four 64-column sub-tiles a tile), f32 on the simt one."""
    q, k, v = _gqa_on_card(dev, 3, 4, 2048, 8, 4, 256, dtype)
    which = fa.design(dtype, 256)
    assert which == ("wgmma" if dtype == torch.bfloat16 else "simt")
    before = dict(fa.flash_attention_gqa.launches_by_design)
    got = fa.flash_attention_gqa(q, k, v, window=window)
    assert fa.flash_attention_gqa.launches_by_design[which] == \
        before[which] + 1
    want = fa.flash_attention_gqa_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert _row_scaled_err(got, want) <= ROW_TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 16, 63, 64, 65, 150])
@pytest.mark.parametrize("hd", [8, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_on_both_instances_matches_plain(dev, dtype, hd, window,
                                                causal):
    """The band mask on each instance against the plain version (run on
    the card, the same tensors): windows inside a tile, on its edges and
    across several, causal and not, S that no tile divides."""
    q, k, v = _gqa_on_card(dev, hd + window, 2, 300, 4, 2, hd, dtype)
    which = fa.design(dtype, hd)
    before = fa.flash_attention_gqa.launches_by_design[which]
    got = fa.flash_attention_gqa(q, k, v, causal=causal, window=window)
    assert fa.flash_attention_gqa.launches_by_design[which] == before + 1
    want = fa.flash_attention_gqa_plain(q, k, v, causal=causal,
                                        window=window)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert _row_scaled_err(got, want) <= ROW_TOL
    if window == 1 and causal:       # each row sees its own key alone
        G = q.shape[2] // k.shape[2]
        torch.testing.assert_close(
            got, v.repeat_interleave(G, dim=2), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 256])
def test_a_window_as_wide_as_s_is_the_global_path(dev, hd, dtype):
    """window >= S keeps every key: bit for bit the global launch."""
    q, k, v = _gqa_on_card(dev, 7, 2, 200, 4, 2, hd, dtype)
    want = fa.flash_attention_gqa(q, k, v)
    for window in (200, 1000):
        torch.testing.assert_close(
            fa.flash_attention_gqa(q, k, v, window=window), want, rtol=0,
            atol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 64, 100, 130])
def test_simt_instance_at_head_dim_256(dev, S, causal):
    """f32 at hd 256 (256 threads a 64-row tile; 212,992 bytes of shared
    memory) against the plain version on the CPU, global and with a
    window of 40."""
    cpu = _attn_inputs(S, (2, S, 4, 256), (2, S, 2, 256), torch.float32)
    for window in (0, 40):
        want = fa.flash_attention_gqa(*cpu, causal=causal, window=window)
        before = fa.flash_attention_gqa.launches_by_design["simt"]
        got = fa.flash_attention_gqa(*(t.to(dev) for t in cpu),
                                     causal=causal, window=window)
        assert fa.flash_attention_gqa.launches_by_design["simt"] == \
            before + 1
        torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)


# The simt instance (f32 at every head dim, bf16 at hd 8) against its
# plain version on the same card tensors: FLASH_TOL (f32 2e-5, the f32
# sums in another order; bf16 3e-2, outputs rounded to 8 bits) and the
# lse within 1e-4 (tests/test_torch_flash_attention.py's LSE_TOL).
SIMT_CASES = [(torch.float32, hd) for hd in fa.HEAD_DIMS] + [
    (torch.bfloat16, 8)]


def _simt_held(q, k, v, **kw):
    """One counted simt launch with the lse against the plain version;
    its output equal bit for bit to the call without the lse."""
    by = fa.flash_attention_gqa.launches_by_design
    before = by["simt"]
    out, lse = fa.flash_attention_gqa(q, k, v, return_lse=True, **kw)
    assert by["simt"] == before + 1
    null = fa.flash_attention_gqa(q, k, v, **kw)
    want, want_lse = fa.flash_attention_gqa_plain(q, k, v, return_lse=True,
                                                  **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, null)
    tol = FLASH_TOL[q.dtype]
    torch.testing.assert_close(out, want, rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    return out


@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 1000])
@pytest.mark.parametrize("dtype,hd", SIMT_CASES,
                         ids=lambda x: str(x).split(".")[-1])
def test_simt_instance_matches_plain(dev, dtype, hd, S, G):
    """Causal and non-causal, global and with a window of 40 (two
    key tiles at S 1000), G query heads a kv head, with the lse."""
    q, k, v = (t.to(dev) for t in _attn_inputs(
        S * hd + G, (2, S, 2 * G, hd), (2, S, 2, hd), dtype))
    for causal in (True, False):
        for window in (0, 40):
            _simt_held(q, k, v, causal=causal, window=window)


@pytest.mark.parametrize("S,Sk", [(1, 1600), (1, 1), (63, 65), (65, 1000),
                                  (1000, 77)])
@pytest.mark.parametrize("dtype,hd", SIMT_CASES,
                         ids=lambda x: str(x).split(".")[-1])
def test_simt_instance_cross_attention_matches_plain(dev, dtype, hd, S, Sk):
    """Keys of their own length (Sk != S, non-causal), Sq 1 included."""
    q, k, v = (t.to(dev) for t in _attn_inputs(
        S + Sk + hd, (2, S, 8, hd), (2, Sk, 2, hd), dtype))
    _simt_held(q, k, v, causal=False)


@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("dtype,hd", SIMT_CASES,
                         ids=lambda x: str(x).split(".")[-1])
def test_simt_instance_at_query_offsets(dev, dtype, hd, window):
    """A rank's rows of a causal call (seq_shard_attn) at offsets that
    are multiples of 64 and at one that is not: within tolerance of the
    plain version, and where the offset is a multiple of 64 equal bit
    for bit to the full call's rows."""
    S = 320
    q, k, v = (t.to(dev) for t in _attn_inputs(
        hd + window, (2, S, 4, hd), (2, S, 2, hd), dtype))
    full = fa.flash_attention_gqa(q, k, v, window=window, return_lse=True)
    for a, b in ((0, 64), (64, 192), (192, 320), (100, 257)):
        got = _simt_held(q[:, a:b], k[:, :b], v[:, :b], window=window,
                         q_offset=a)
        if a % 64 == 0:
            assert torch.equal(got, full[0][:, a:b])


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 64),
                                      (torch.float32, 128),
                                      (torch.float32, 256),
                                      (torch.bfloat16, 8)],
                         ids=lambda x: str(x).split(".")[-1])
def test_simt_instance_reads_views_that_take_one_element_copies(dev, dtype,
                                                                hd):
    """Views no 16-byte copy can read: q, k and v cut from a buffer whose
    rows are hd + 1 elements, one element in, so pointers and strides are
    not whole 16-byte chunks. The launch copies one element at a time and
    gives the result of the contiguous call (16-byte copies) bit for
    bit, within tolerance of the plain version."""
    gen = torch.Generator(device=dev).manual_seed(hd)
    buf = torch.randn(2, 130, 9, hd + 1, generator=gen, device=dev).to(dtype)
    q, k, v = buf[:, :, 0:4, 1:], buf[:, :, 4:6, 1:], buf[:, :, 6:8, 1:]
    assert q.data_ptr() % 16 and q.stride(2) % 4
    for causal, window in ((True, 0), (True, 50), (False, 0)):
        got = _simt_held(q, k, v, causal=causal, window=window)
        wide = fa.flash_attention_gqa(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal,
                                      window=window)
        assert torch.equal(got, wide)


def test_simt_instances_spill_nothing(dev):
    """ptxas -v on every simt entry of the built library (f32 at each
    head dim and bf16 at 8, global and windowed, with 16-byte and with
    one-element copies): no stack frame, no bytes spilled to local
    memory."""
    log = _build.ptxas_log("flash_attention").splitlines()
    entries = [i for i, ln in enumerate(log)
               if "Compiling entry function" in ln and "simt9flash_fwd" in ln]
    assert len(entries) == 4 * len(SIMT_CASES)
    for i in entries:
        props = next(x for x in log[i + 1:] if "spill stores" in x).strip()
        name = log[i].split("flash_fwdI")[1].split("EEEv")[0]
        assert props == ("0 bytes stack frame, 0 bytes spill stores, "
                         "0 bytes spill loads"), (name, props)


def test_gemma3_smoke_on_the_card_matches_the_cpu(dev):
    """The smoke gemma3 in f32 (local layers of window 16 beside a global
    one) at S 100: prefill logits on the card within 1e-4 of the CPU's,
    one B4 launch a layer, and three decode steps past the window."""
    import dataclasses
    from repro_torch.configs import gemma3_4b
    from repro_torch.models import model as M
    cfg = dataclasses.replace(gemma3_4b.smoke_config(), dtype="float32")
    params = M.init(cfg, seed=0, device="cpu")
    on_card = _to(params, dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32))
    runs = {}
    for where, p, t in (("cpu", params, tokens),
                        ("card", on_card, tokens.to(dev))):
        before = fa.flash_attention_gqa.launches
        logits, _, kv = M.apply_prefill(p, cfg, {"tokens": t})
        launched = fa.flash_attention_gqa.launches - before
        cache = M.init_cache(cfg, 2, 103, t.device)
        cache["k"][:, :, :100] = kv["k"]
        cache["v"][:, :, :100] = kv["v"]
        steps = []
        for i in range(3):
            step, _, cache = M.apply_decode(p, cfg, {"tokens": t[:, i:i + 1]},
                                            cache, 100 + i)
            steps.append(step.cpu())
        runs[where] = (logits.cpu(), torch.cat(steps, 1), launched)
    assert runs["cpu"][2] == 0 and runs["card"][2] == cfg.n_layers
    for a, b in zip(runs["card"][:2], runs["cpu"][:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_qwen3_moe_smoke_on_the_card_matches_the_cpu(dev):
    """The smoke qwen3-moe in f32: prefill and one decode step on the card
    (B4 at every layer, the MoE's gathers, sorts and batched products on
    the card) within 1e-4 of the CPU port's logits, the same expert ids
    and the same kept assignments in every layer, and the same aux."""
    import dataclasses
    from repro_torch.configs import qwen3_moe_235b_a22b
    from repro_torch.models import model as M, moe
    cfg = dataclasses.replace(qwen3_moe_235b_a22b.smoke_config(),
                              dtype="float32")
    params = M.init(cfg, seed=0, device="cpu")
    on_card = _to(params, dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 100)).astype(np.int32))
    runs = {}
    try:
        for where, p, t in (("cpu", params, tokens),
                            ("card", on_card, tokens.to(dev))):
            moe.moe_apply.record = []
            before = fa.flash_attention_gqa.launches
            logits, aux, kv = M.apply_prefill(p, cfg, {"tokens": t})
            launched = fa.flash_attention_gqa.launches - before
            cache = M.init_cache(cfg, 4, 101, t.device)
            cache["k"][:, :, :100] = kv["k"]
            cache["v"][:, :, :100] = kv["v"]
            step, _, _ = M.apply_decode(p, cfg, {"tokens": t[:, -1:]}, cache,
                                        100)
            runs[where] = (logits.cpu(), float(aux), step.cpu(), launched,
                           [(r["expert_id"].cpu(), r["kept"].cpu())
                            for r in moe.moe_apply.record])
    finally:
        moe.moe_apply.record = None
    cpu, card = runs["cpu"], runs["card"]
    assert cpu[3] == 0 and card[3] == cfg.n_layers
    torch.testing.assert_close(card[0], cpu[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(card[2], cpu[2], rtol=1e-4, atol=1e-4)
    assert abs(card[1] - cpu[1]) <= 1e-5 * max(1.0, abs(cpu[1]))
    assert len(card[4]) == 2 * cfg.n_layers          # prefill and decode
    for (ids_c, kept_c), (ids_g, kept_g) in zip(cpu[4], card[4]):
        assert torch.equal(ids_c, ids_g) and torch.equal(kept_c, kept_g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gqa_at_the_zamba2_prefill_shape(dev, dtype):
    """zamba2's shared attention: 32 heads over 32 (G = 1) at hd 64, B 4,
    S 1024: bf16 on the wgmma instance, f32 on the simt one, each within
    its tolerance of the plain version and counted under its instance."""
    q, k, v = _gqa_on_card(dev, 3, 4, 1024, 32, 32, 64, dtype)
    which = fa.design(dtype, 64)
    before = dict(fa.flash_attention_gqa.launches_by_design)
    got = fa.flash_attention_gqa(q, k, v)
    assert fa.flash_attention_gqa.launches_by_design[which] == \
        before[which] + 1
    want = fa.flash_attention_gqa_plain(q, k, v)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert _row_scaled_err(got, want) <= ROW_TOL


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b"])
def test_recurrent_smoke_on_the_card_matches_the_cpu(dev, arch):
    """The smoke rwkv6 and zamba2 in f32 at S 128 (two chunks of 64):
    prefill logits and three decode steps on the card (the WKV and SSD
    scans in f32, not TF32; B4 at each of zamba2's shared-attention
    sites, never for rwkv6) within 1e-4 of the CPU's."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import hybrid, model as M
    from repro_torch.serve import step
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype="float32")
    params = M.init(cfg, seed=0, device="cpu")
    on_card = _to(params, dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 131)).astype(np.int32))
    runs = {}
    for where, p, t in (("cpu", params, tokens),
                        ("card", on_card, tokens.to(dev))):
        before = fa.flash_attention_gqa.launches
        logits, _, kv = M.apply_prefill(p, cfg, {"tokens": t[:, :128]})
        launched = fa.flash_attention_gqa.launches - before
        cache = step.decode_cache(cfg, kv, 2, 128, 131, t.device)
        steps = []
        for i in range(3):
            lg, _, cache = M.apply_decode(
                p, cfg, {"tokens": t[:, 128 + i:129 + i]}, cache, 128 + i)
            steps.append(lg.cpu())
        runs[where] = (logits.cpu(), torch.cat(steps, 1), launched)
    want = hybrid.n_attn_sites(cfg) if cfg.family == "hybrid" else 0
    assert runs["cpu"][2] == 0 and runs["card"][2] == want
    for a, b in zip(runs["card"][:2], runs["cpu"][:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# cross-attention (Sk != S, non-causal) and the two multimodal archs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Sk", [(1, 1600), (1, 100), (37, 16),
                                  (130, 1600), (1024, 1000), (64, 65)])
@pytest.mark.parametrize("hd", [64, 128])
def test_cross_attention_on_both_instances_matches_plain(dev, hd, S, Sk,
                                                         dtype):
    """Keys of their own length: one query over the VLM's 1600 image
    tokens (decode), query tiles over fewer keys than a tile and over a
    last key tile that is partial (1000, 100, 65), non-causal, 8 heads
    over 2; each launch counted under the instance ``design`` names and
    as a cross-attention launch."""
    q, k, v = (t.to(dev) for t in _attn_inputs(
        S * Sk + hd, (2, S, 8, hd), (2, Sk, 2, hd), dtype))
    which = fa.design(dtype, hd)
    before = dict(fa.flash_attention_gqa.launches_by_design)
    cross = fa.flash_attention_gqa.launches_cross
    got = fa.flash_attention_gqa(q, k, v, causal=False)
    after = fa.flash_attention_gqa.launches_by_design
    assert after[which] == before[which] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    assert fa.flash_attention_gqa.launches_cross == cross + 1
    want = fa.flash_attention_gqa_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == dtype
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert _row_scaled_err(got, want) <= ROW_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_at_the_vlm_prefill_shape(dev, dtype):
    """llama-3.2-vision's cross layer: q [4, 1024, 64, 128] over the
    image's k, v [4, 1600, 8, 128], non-causal."""
    q, k, v = (t.to(dev) for t in _attn_inputs(
        5, (4, 1024, 64, 128), (4, 1600, 8, 128), dtype))
    which = fa.design(dtype, 128)
    before = fa.flash_attention_gqa.launches_by_design[which]
    got = fa.flash_attention_gqa(q, k, v, causal=False)
    assert fa.flash_attention_gqa.launches_by_design[which] == before + 1
    want = fa.flash_attention_gqa_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert _row_scaled_err(got, want) <= ROW_TOL


def test_cross_attention_refuses_causal_or_windowed_on_the_card(dev):
    q, k, v = _gqa_on_card(dev, 0, 1, 64, 2, 1, 64)
    k2, v2 = k[:, :40].contiguous(), v[:, :40].contiguous()
    before = fa.flash_attention_gqa.launches
    for kw in ({"causal": True}, {"causal": False, "window": 16}):
        with pytest.raises(ValueError, match="non-causal with no window"):
            fa.flash_attention_gqa(q, k2, v2, **kw)
    with pytest.raises(TypeError, match="share"):
        fa.flash_attention_gqa(q.float(), k2, v2, causal=False)
    assert fa.flash_attention_gqa.launches == before


@pytest.mark.parametrize("arch", ["musicgen-medium", "llama-3.2-vision-90b"])
def test_multimodal_smoke_on_the_card_matches_the_cpu(dev, arch):
    """The smoke musicgen (on frame embeddings) and VLM (tokens beside f32
    image embeddings) in f32: prefill logits and three decode steps on the
    card within 1e-4 of the CPU's; B4 once a layer in prefill (the VLM's
    cross layers at Sk 16), and once a cross layer a decode step."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import model as M, transformer
    from repro_torch.serve import step
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype="float32")
    params = M.init(cfg, seed=0, device="cpu")
    on_card = _to(params, dev)
    rng = np.random.default_rng(0)
    embeds = torch.from_numpy(rng.standard_normal(
        (2, 103, cfg.d_model)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 103))
                              .astype(np.int32))
    img = torch.from_numpy((rng.standard_normal(
        (2, max(cfg.n_image_tokens, 1), cfg.d_model)) * 0.02)
        .astype(np.float32))
    n_sb = transformer.n_superblocks(cfg)
    runs = {}
    for where, p in (("cpu", params), ("card", on_card)):
        d = torch.device("cpu") if where == "cpu" else dev
        if cfg.embeds_input:
            pre = {"embeds": embeds[:, :100].to(d)}
            steps = [{"embeds": embeds[:, 100 + i:101 + i].to(d)}
                     for i in range(3)]
        else:
            pre = {"tokens": tokens[:, :100].to(d), "image_embeds": img.to(d)}
            steps = [{"tokens": tokens[:, 100 + i:101 + i].to(d)}
                     for i in range(3)]
        before = fa.flash_attention_gqa.launches
        cross = fa.flash_attention_gqa.launches_cross
        logits, _, kv = M.apply_prefill(p, cfg, pre)
        launched = [fa.flash_attention_gqa.launches - before]
        cache = step.decode_cache(cfg, kv, 2, 100, 103, d)
        outs = []
        for i, b in enumerate(steps):
            before = fa.flash_attention_gqa.launches
            lg, _, cache = M.apply_decode(p, cfg, b, cache, 100 + i)
            launched.append(fa.flash_attention_gqa.launches - before)
            outs.append(lg.cpu())
        launched.append(fa.flash_attention_gqa.launches_cross - cross)
        runs[where] = (logits.cpu(), torch.cat(outs, 1), launched)
    assert runs["cpu"][2] == [0] * 5
    # one a layer in prefill, one a cross layer a decode step; of them,
    # the cross layers' (Sk != S) 4 * n_sb
    assert runs["card"][2] == [cfg.n_layers + n_sb] + [n_sb] * 3 \
        + [4 * n_sb]
    for a, b in zip(runs["card"][:2], runs["cpu"][:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# training: B4's log-sum-exp, and the autograd Function's gradients
# ---------------------------------------------------------------------------
# both sum the same f32 exps in another order; lse is ~1-10 at these
# shapes and f32 keeps ~1e-6 of it
LSE_TOL = 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (name, q shape, kv shape, causal, window): phase 8's shapes
    ("qwen2 hd 64", (4, 1024, 14, 64), (4, 1024, 2, 64), True, 0),
    ("qwen3 hd 128", (4, 1024, 32, 128), (4, 1024, 8, 128), True, 0),
    ("gemma3 hd 256", (2, 2048, 8, 256), (2, 2048, 4, 256), True, 0),
    ("gemma3 hd 256 window", (2, 2048, 8, 256), (2, 2048, 4, 256), True,
     1024),
    ("zamba2 G=1", (4, 1024, 32, 64), (4, 1024, 32, 64), True, 0),
    ("vlm cross Sk 1600", (2, 1024, 64, 128), (2, 1600, 8, 128), False, 0),
    ("S 1000 partial tile", (2, 1000, 8, 64), (2, 1000, 2, 64), True, 0),
    ("hd 8", (2, 130, 4, 8), (2, 130, 2, 8), True, 0)],
    ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_lse_matches_plain_on_every_instance(dev, case, dtype):
    """B4's lse (f32 [B, H, S]) against the plain version's on the same
    card tensors within LSE_TOL, its output equal bit for bit to the call
    without the lse, one launch counted as an lse launch under the
    instance ``design`` names."""
    _, q_shape, kv_shape, causal, window = case
    q, k, v = (t.to(dev) for t in _attn_inputs(sum(q_shape), q_shape,
                                                kv_shape, dtype))
    which = fa.design(dtype, q_shape[-1])
    by = fa.flash_attention_gqa.launches_by_design
    before, lse_before = by[which], fa.flash_attention_gqa.launches_lse
    out, lse = fa.flash_attention_gqa(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    assert by[which] == before + 1
    assert fa.flash_attention_gqa.launches_lse == lse_before + 1
    null = fa.flash_attention_gqa(q, k, v, causal=causal, window=window)
    want, want_lse = fa.flash_attention_gqa_plain(
        q, k, v, causal=causal, window=window, return_lse=True)
    torch.cuda.synchronize()
    B, S, H, _ = q_shape
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert torch.equal(out, null)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=LSE_TOL)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out, want, rtol=tol, atol=tol)


# the Function's dq, dk, dv against autograd through f32 attention,
# relative Frobenius error: f32 sums in other orders (~4e-7 on the CPU);
# bf16 inputs are the same values in both, but B4's bf16 output enters
# delta = sum(dout * out) (~2e-3 on the CPU), and a 64-key tile dropped
# for half the query rows moves them ~4e-2
GRAD_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _dense_attention(q, k, v, drop_tile=False):
    """Causal attention as one f32 softmax over [S, S] scores: (out, lse
    [B, H, S]). ``drop_tile``: rows from 512 on miss keys 64-127."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kk, vv = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(hd)
    i = torch.arange(S, device=q.device)
    keep = i[:, None] >= i[None, :]
    if drop_tile:
        keep &= ~((i[:, None] >= 512) & (i[None, :] >= 64)
                  & (i[None, :] < 128))
    s = s.masked_fill(~keep, -1e30)
    return (torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv),
            torch.logsumexp(s, -1))


def _function_grads_held(dev, q_shape, kv_shape, dtype):
    """``layers.blockwise_attention`` under autograd (B4 with its lse,
    then the plain backward) against autograd through f32 attention on
    the same inputs; in bf16 a planted fault, a dropped key tile in the
    forward, breaks the limit."""
    from repro_torch.models import layers
    q, k, v = (t.to(dev) for t in _attn_inputs(11, q_shape, kv_shape,
                                                dtype))
    dout = _attn_inputs(12, q_shape, (1, 1, 1, 1), dtype)[0].to(dev)
    ref = [t.float().requires_grad_(True) for t in (q, k, v)]
    _dense_attention(*ref)[0].backward(dout.float())
    want = [t.grad for t in ref]

    def errors():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = layers.blockwise_attention(*leaves)
        assert out.grad_fn is not None
        out.backward(dout)
        return [float((t.grad.float() - w).norm() / w.norm())
                for t, w in zip(leaves, want)]

    before = fa.flash_attention_gqa.launches_lse
    errs = errors()
    assert fa.flash_attention_gqa.launches_lse == before + 1
    assert max(errs) <= GRAD_REL_TOL[dtype], errs
    if dtype == torch.bfloat16:
        real = layers.flash_attention_gqa

        def dropped(q, k, v, causal=True, window=0, return_lse=True):
            out, lse = _dense_attention(q.float(), k.float(), v.float(),
                                        drop_tile=True)
            return out.to(q.dtype), lse
        layers.flash_attention_gqa = dropped
        try:
            faulty = errors()
        finally:
            layers.flash_attention_gqa = real
        assert max(faulty) > GRAD_REL_TOL[dtype], faulty


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_gradients_at_the_qwen3_layer_shape(dev, dtype):
    """qwen3-4b's training layer shape: 32 heads over 8 at hd 128."""
    _function_grads_held(dev, (4, 1024, 32, 128), (4, 1024, 8, 128), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_gradients_at_the_zamba2_layer_shape(dev, dtype):
    """zamba2's shared attention as it trains: 32 heads over 32 (G = 1)
    at hd 64, B 4, S 1024 (its lse is held by
    ``test_lse_matches_plain_on_every_instance``)."""
    _function_grads_held(dev, (4, 1024, 32, 64), (4, 1024, 32, 64), dtype)


# WKVChunked against plain autograd through the scan a chunk at a time on
# the same card tensors, relative Frobenius error: the same f32 terms, the
# backward's sums group by group (~1e-7 on the CPU); r, k and v's
# gradients in bf16 may round one ulp (2^-8 relative) the other way
WKV_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_bytes", [None, 1 << 25],
                         ids=["one-group", "groups"])
def test_wkv_function_matches_the_plain_scan_on_the_card(dev, dtype,
                                                         d_bytes,
                                                         monkeypatch):
    """rwkv6's WKV scan at B 2, T 512 (8 chunks of 64), 8 heads of 64,
    from a nonzero state with a cotangent on the state out: the Function's
    output and state equal the no-grad scan's bit for bit, its gradients
    are the plain version's within WKV_GRAD_TOL, and its backward run
    twice gives the same bits."""
    from repro_torch.models import rwkv6
    if d_bytes is not None:        # 2 chunks a group
        monkeypatch.setattr(rwkv6, "D_BYTES", d_bytes)
    g = torch.Generator(device=dev).manual_seed(5)
    B, T, H, hd = 2, 512, 8, 64

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    r, k, v = (randn(B, T, H, hd).to(dtype) for _ in range(3))
    lw = -torch.exp(randn(B, T, H, hd, scale=0.5) - 2.0)
    ins = (r, k, v, lw, randn(H, hd), randn(B, H, hd, hd, scale=0.3))
    cot = (randn(B, T, H, hd).to(dtype), randn(B, H, hd, hd))
    with torch.no_grad():
        want_out = rwkv6._wkv_chunked(*ins, 64)
    runs = []
    for fn in (rwkv6._wkv_chunked, rwkv6._wkv_chunked, rwkv6.wkv_chunked_plain):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        out = fn(*leaves, 64)
        runs.append((out, torch.autograd.grad(out, leaves, cot)))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], want_out))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    for got, want in zip(runs[0][1], runs[2][1]):
        err = float((got.float() - want.float()).norm() / want.float().norm())
        assert err <= WKV_GRAD_TOL[got.dtype], err


def test_qwen3_smoke_trains_on_the_card_as_on_the_cpu(dev):
    """The smoke qwen3 in f32: the loss and every gradient of one batch on
    the card (B4 forward twice a layer: the step and remat's recompute)
    within 1e-4 of the CPU's (plain attention; sums in other orders)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt
    cfg = dataclasses.replace(registry.get_smoke_config("qwen3-4b"),
                              dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32))
    runs = []
    for where in ("cpu", dev):
        params = M.init(cfg, seed=0, device="cpu")
        params = opt.tree_map(lambda t: t.to(where).requires_grad_(True),
                              params)
        before = fa.flash_attention_gqa.launches
        loss, _ = M.loss_fn(params, cfg, {"tokens": tokens.to(where)})
        leaves = [p for _, p in opt.flatten(params)]
        grads = torch.autograd.grad(loss, leaves)
        launched = fa.flash_attention_gqa.launches - before
        runs.append((float(loss), [g.cpu() for g in grads], launched))
    assert runs[0][2] == 0 and runs[1][2] == 2 * cfg.n_layers
    assert runs[1][0] == pytest.approx(runs[0][0], rel=1e-4)
    for a, b in zip(runs[1][1], runs[0][1]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b"])
def test_recurrent_smoke_trains_on_the_card_as_on_the_cpu(dev, arch):
    """The smoke rwkv6 and zamba2 in f32 at S 128 (two chunks of 64): the
    loss and every gradient of one batch on the card within 1e-4 of the
    CPU's; B4 once a shared-attention site (the shared block is not
    rematerialized), never for rwkv6."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import hybrid, model as M
    from repro_torch.train import optimizer as opt
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128)).astype(np.int32))
    runs = []
    for where in ("cpu", dev):
        params = M.init(cfg, seed=0, device="cpu")
        params = opt.tree_map(lambda t: t.to(where).requires_grad_(True),
                              params)
        before = fa.flash_attention_gqa.launches_lse
        loss, _ = M.loss_fn(params, cfg, {"tokens": tokens.to(where)})
        leaves = [p for _, p in opt.flatten(params)]
        grads = torch.autograd.grad(loss, leaves)
        launched = fa.flash_attention_gqa.launches_lse - before
        runs.append((float(loss), [g.cpu() for g in grads], launched))
    want = hybrid.n_attn_sites(cfg) if cfg.family == "hybrid" else 0
    assert runs[0][2] == 0 and runs[1][2] == want
    assert runs[1][0] == pytest.approx(runs[0][0], rel=1e-4)
    for a, b in zip(runs[1][1], runs[0][1]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


# -- the search engine on a 1 x 1 mesh through NCCL ----------------------
@pytest.fixture(scope="module")
def nccl_ctx(dev, tmp_path_factory):
    """A world of one rank over NCCL, a 1 x 1 ("data", "model") mesh on
    the card; the group is destroyed after the module."""
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.meshctx import MeshCtx
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120),
                            device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        yield MeshCtx(mesh, device=dev)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("backend", ["gpu", "gpu_packed"])
def test_nccl_1x1_mesh_engine_equals_the_single_device_engine(
        dev, nccl_ctx, backend):
    cfg = SearchConfig(name="card-mesh", vocab_size=20000,
                       avg_nnz_per_doc=40, nnz_pad=64, top_k=16)
    corpus = corpus_lib.synthesize(1 << 14, cfg.vocab_size, 40, cfg.nnz_pad,
                                   seed=29)
    single = PatternSearchEngine(corpus, cfg, dev, backend)
    mesh = PatternSearchEngine(corpus, cfg, backend=backend, ctx=nccl_ctx)
    assert torch.distributed.get_backend(nccl_ctx.group("data")) == "nccl"
    rng = np.random.default_rng(29)
    counts = {b.__name__: 0 for b in (sparse_match, sparse_match_packed)}
    for L in (1, 3, 8):
        idx = rng.integers(0, corpus.n_docs, L)
        qs = [corpus_lib.make_query(corpus, int(i), cfg.max_query_nnz)
              for i in idx]
        q = _query(np.stack([x[0] for x in qs]), np.stack([x[1] for x in qs]))
        want = single.search_typed(q)
        for fn in (sparse_match, sparse_match_packed):
            fn.launches = 0
        got = mesh.search_typed(q)
        for fn in (sparse_match, sparse_match_packed):
            counts[fn.__name__] += fn.launches
        np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
        np.testing.assert_array_equal(got.scores.view(np.uint32),
                                      want.scores.view(np.uint32))
        np.testing.assert_array_equal(got.doc_ids[:, 0], idx)
    name = "sparse_match" if backend == "gpu" else "sparse_match_packed"
    assert counts[name] == 3
