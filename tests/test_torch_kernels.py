"""Each ported kernel module against the JAX package's, on the CPU.

The JAX side runs as its own tests run it: ``ops.correlate(backend=
"pallas"|"pallas_packed")`` and ``ops.fused_topk`` fall into Pallas
interpret mode on the CPU. The port's wrappers, given CPU tensors, run
their plain PyTorch versions (the versions the CUDA kernels are held
against on the card). Fixtures follow ``_adversarial_case`` of
tests/test_backend_equivalence.py: doc pads, query pads, duplicate ids
in docs and in the merged stream, empty docs, empty query columns.
Integral counts must agree bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused as j_fused
from repro.kernels import ops as j_ops
from repro.kernels.sparse_match_packed import pack
from repro_torch.kernels import fused as t_fused
from repro_torch.kernels import ops as t_ops

torch.set_num_threads(2)
VOCAB = 256
PAIRS = [("jnp", "torch"), ("pallas", "gpu"), ("pallas_packed", "gpu_packed")]


def _adversarial_case(seed):
    rng = np.random.default_rng(seed)
    D = int(rng.integers(1, 33))
    K = int(rng.integers(1, 17))
    Qm = int(rng.integers(1, 49))
    L = int(rng.integers(1, 5))
    ids = np.full((D, K), -1, np.int32)
    vals = np.zeros((D, K), np.float32)
    for d in range(D):
        if rng.random() < 0.15:
            continue                               # empty document
        k = int(rng.integers(1, K + 1))
        row = rng.integers(0, VOCAB, k)
        if k > 1 and rng.random() < 0.3:
            row[0] = row[1]                        # duplicate id in a doc
        ids[d, :k] = np.sort(row).astype(np.int32)
        vals[d, :k] = rng.integers(0, 30, k)       # zero vals possible
    mi = np.full(Qm, -2, np.int32)
    mv = np.zeros((Qm, L), np.float32)
    for j in range(Qm):
        if rng.random() < 0.2:
            continue                               # query pad
        mi[j] = int(rng.integers(0, VOCAB))
        mv[j, int(rng.integers(0, L))] = float(rng.integers(1, 30))
    if L > 1 and rng.random() < 0.3:
        mv[:, 0] = 0.0                             # empty query column
    order = np.argsort(np.where(mi < 0, VOCAB + 1, mi), kind="stable")
    return ids, vals, mi[order], mv[order]


def _jax_corr(backend, ids, vals, mi, mv):
    docs = pack(ids, vals) if backend == "pallas_packed" else ids
    return np.asarray(j_ops.correlate(
        jnp.asarray(docs), jnp.asarray(vals), jnp.asarray(mi),
        jnp.asarray(mv), backend=backend, vocab_size=VOCAB, block_docs=8,
        block_query=8))


def _port_corr(backend, ids, vals, mi, mv):
    docs = pack(ids, vals).view(np.int32) if backend == "gpu_packed" else ids
    return t_ops.correlate(
        torch.from_numpy(docs), torch.from_numpy(vals),
        torch.from_numpy(mi), torch.from_numpy(mv), backend=backend,
        vocab_size=VOCAB, block_docs=8, block_query=8).numpy()


@pytest.mark.parametrize("jb,tb", PAIRS)
@pytest.mark.parametrize("seed", [11, 12])
def test_correlate_bit_identical_on_adversarial_cases(jb, tb, seed):
    ids, vals, mi, mv = _adversarial_case(seed)
    np.testing.assert_array_equal(_port_corr(tb, ids, vals, mi, mv),
                                  _jax_corr(jb, ids, vals, mi, mv))


@pytest.mark.parametrize("jb,tb", PAIRS)
def test_sentinels_duplicates_and_empty_stream(jb, tb):
    """All-pad docs x all-pad queries score exactly zero even with large
    values in the pad slots; a repeated id multiplies out (2+3)*(1+10);
    an empty merged stream scores zero."""
    ids = np.full((8, 8), -1, np.int32)
    vals = np.full((8, 8), 1000.0, np.float32)
    mi = np.full(8, -2, np.int32)
    mv = np.full((8, 2), 1000.0, np.float32)
    if tb == "gpu_packed":
        vals[:] = 0.0       # pack() keeps only what a word can carry
    out = _port_corr(tb, ids, vals, mi, mv)
    np.testing.assert_array_equal(out, _jax_corr(jb, ids, vals, mi, mv))
    np.testing.assert_array_equal(out, 0.0)
    dup = (np.array([[7, 7, -1, -1]], np.int32),
           np.array([[2.0, 3.0, 0.0, 0.0]], np.float32),
           np.array([7, 7, -2, -2], np.int32),
           np.array([[1.0], [10.0], [5.0], [5.0]], np.float32))
    out = _port_corr(tb, *dup)
    np.testing.assert_array_equal(out, _jax_corr(jb, *dup))
    np.testing.assert_array_equal(out, [[(2 + 3) * (1 + 10)]])
    empty = (dup[0], dup[1], np.empty(0, np.int32),
             np.zeros((0, 3), np.float32))
    out = _port_corr(tb, *empty)
    np.testing.assert_array_equal(out, _jax_corr(jb, *empty))
    np.testing.assert_array_equal(out, np.zeros((1, 3), np.float32))


@pytest.mark.parametrize("tb", ["torch", "gpu"])
def test_correlate_float_values_within_tolerance(tb):
    """Arbitrary float values: sums are taken in another order than the
    JAX kernels', so exactness is not promised. Each output is a sum of
    at most K * Qm products of magnitude <= max|val| * max|q|; the test
    holds rtol 1e-5 and an atol of 1e-5 x the largest |score|, which
    bounds float32 rounding of such sums whatever their order."""
    ids, vals, mi, mv = _adversarial_case(5)
    rng = np.random.default_rng(5)
    vals = (vals * rng.random(vals.shape)).astype(np.float32)
    mv = (mv * rng.standard_normal(mv.shape)).astype(np.float32)
    want = _jax_corr("pallas", ids, vals, mi, mv)
    got = _port_corr(tb, ids, vals, mi, mv)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_unsorted_stream_scores_like_reference():
    """The kernels' run lookup binary-searches a sorted stream and scans
    any other; the plain version must not depend on the order either."""
    ids, vals, mi, mv = _adversarial_case(3)
    perm = np.random.default_rng(3).permutation(mi.size)
    np.testing.assert_array_equal(
        _port_corr("gpu", ids, vals, mi[perm], mv[perm]),
        _jax_corr("pallas", ids, vals, mi[perm], mv[perm]))


def test_merge_queries_and_cosine_scores_identical():
    rng = np.random.default_rng(0)
    qi = np.where(rng.random((4, 6)) < 0.3, -1,
                  rng.integers(0, VOCAB, (4, 6))).astype(np.int32)
    qi[2] = -1                                     # an empty row
    qv = rng.integers(1, 9, (4, 6)).astype(np.float32)
    for g, w in zip(t_ops.merge_queries(qi, qv), j_ops.merge_queries(qi, qv)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    corr = rng.standard_normal((5, 3)).astype(np.float32)
    norms = np.array([0, 1, 2.5, 3, 0], np.float32)
    qn = np.array([1, 0, 2], np.float32)
    got = t_ops.cosine_scores(*map(torch.from_numpy, (corr, norms, qn)))
    want = j_ops.cosine_scores(*map(jnp.asarray, (corr, norms, qn)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _fused_case(seed, nnz_pad, bd):
    rng = np.random.default_rng(seed)
    docs = []
    for d in range(int(rng.integers(1, 40))):
        nw = int(rng.integers(0, 12))
        ws = sorted(rng.choice(VOCAB, nw, replace=False).tolist())
        docs.append((d, [(int(w), int(rng.integers(1, 30))) for w in ws]))
    from repro.core.stream_format import encode
    tiles, _, _ = j_fused.tile_stream(encode(docs), block_docs=bd,
                                      nnz_pad=nnz_pad)
    _, _, mi, mv = _adversarial_case(seed)
    qn = np.sqrt((mv ** 2).sum(0)).astype(np.float32)
    return tiles, mi, mv, qn


@pytest.mark.parametrize("seed,nnz_pad,bd,k", [(0, 4, 4, 3), (1, 9, 8, 16),
                                               (2, 12, 16, 5)])
def test_fused_topk_bit_identical(seed, nnz_pad, bd, k):
    """Per-tile candidates (the kernel's own output) and the folded
    winners both match the Pallas kernel in interpret mode, ties and
    -inf pads included."""
    tiles, mi, mv, qn = _fused_case(seed, nnz_pad, bd)
    kp = min(k, bd)
    tq = max(-(-mi.size // 8) * 8, 8)
    qi = np.where(np.pad(mi, (0, tq - mi.size), constant_values=-2) < 0, -2,
                  np.pad(mi, (0, tq - mi.size)))
    qv = np.pad(mv, ((0, tq - mi.size), (0, 0)))
    jv, ji = j_fused.fused_match_topk(
        jnp.asarray(tiles), jnp.asarray(qi), jnp.asarray(qv),
        jnp.asarray(qn), block_docs=bd, kp=kp, block_query=8,
        interpret=True)
    tv, ti = t_fused.fused_match_topk(
        torch.from_numpy(tiles.view(np.int32)), torch.from_numpy(qi),
        torch.from_numpy(qv), torch.from_numpy(qn), block_docs=bd, kp=kp)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    fv, fi = t_ops.fused_topk(
        torch.from_numpy(tiles.view(np.int32)), torch.from_numpy(mi),
        torch.from_numpy(mv), torch.from_numpy(qn), k=k, block_docs=bd,
        block_query=8)
    gv, gi = j_ops.fused_topk(jnp.asarray(tiles), jnp.asarray(mi),
                              jnp.asarray(mv), jnp.asarray(qn), k=k,
                              block_docs=bd, block_query=8)
    np.testing.assert_array_equal(fv.numpy(), np.asarray(gv))
    np.testing.assert_array_equal(fi.numpy(), np.asarray(gi))


def test_fused_nan_ranks_as_inf_and_ties_keep_lower_row():
    """A NaN cosine ranks with +inf, ties go to the lower row, pad rows
    never surface ahead of real ones: the Pallas epilogue's ranking. The
    NaN comes from inf / inf (doc 2's score overflows; the query norm is
    infinite). Column 0 agrees with the Pallas kernel bit for bit. In
    column 1 the Pallas kernel's one-hot segment-sum matmul also turns
    every other row of the tile into NaN (0 * inf), so all tie; the port
    scores those rows 0, as the staged reference path does (ROADMAP,
    queue C)."""
    from repro.core.stream_format import encode
    docs = [(0, [(5, 1)]), (1, [(5, 1)]), (2, [(6, 2)]), (3, [(5, 1)])]
    tiles, _, _ = j_fused.tile_stream(encode(docs), block_docs=8,
                                      nnz_pad=2)
    mi = np.array([5, 6, -2, -2, -2, -2, -2, -2], np.int32)
    mv = np.zeros((8, 2), np.float32)
    mv[0, 0], mv[1, 1] = 3.0, 3e38
    qn = np.array([3.0, np.inf], np.float32)
    args = dict(block_docs=8, kp=5)
    jv, ji = j_fused.fused_match_topk(
        *map(jnp.asarray, (tiles, mi, mv, qn)), interpret=True, **args)
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = t_fused.fused_match_topk(
        torch.from_numpy(tiles.view(np.int32)),
        *map(torch.from_numpy, (mi, mv, qn)), **args)
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_array_equal(ti[0, 0], ji[0, 0])
    np.testing.assert_array_equal(tv[0, 0], jv[0, 0])
    np.testing.assert_array_equal(ti[0, 0, :4], [0, 1, 3, 2])
    np.testing.assert_array_equal(ti[0, 1], [2, 0, 1, 3, -1])
    assert np.isnan(tv[0, 1, 0]) and (tv[0, 1, 1:4] == 0).all()
    np.testing.assert_array_equal(ji[0, 1], [0, 1, 2, 3, -1])
    assert np.isnan(jv[0, 1, :4]).all()
