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
from repro_torch.kernels.sparse_match import (MAX_KEY, query_tile_bytes,
                                              query_tiles, table_plan)

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
    """The kernels look a sorted stream's ids up in a hashed table and
    scan any other; the plain version must not depend on the order
    either."""
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


# -- the hashed query table of B1-B3 (csrc/match.cuh) ---------------------
def _query_tile_bytes(items):
    """A query tile's shared memory: its ids and a table at load 1/2."""
    slots = 64
    while slots < 2 * items:
        slots *= 2
    return -(-4 * items // 16) * 16 + -(-2 * slots // 16) * 16


@pytest.mark.parametrize("n_real,items,slots", [
    (0, 1, 64), (16, 512, 64), (17, 512, 128), (50, 512, 256),
    (402, 4096, 2048), (700, 4096, 2048), (2048, 4096, 8192),
    (3000, 4096, 8192), (4096, 4096, 8192), (8192, 8192, 16384)])
def test_table_slots_quarter_load_where_it_fits(n_real, items, slots):
    """B3's table (8-column sums, the tile's least shared memory): the
    least power of two >= 4 x the real items (at least 64) where it fits
    beside the ids and the sums, else half that (700 real items: half,
    because the sums then fit)."""
    assert query_tile_bytes(items) == _query_tile_bytes(items)
    assert table_plan(n_real, query_tile_bytes(items), 8, 8)[0] == slots


@pytest.mark.parametrize("n_real,tile_bytes,min_cols,plan", [
    (402, 32768, 8, (2048, 8)), (700, 32768, 8, (2048, 8)),
    (800, 32768, 8, (4096, 0)), (1000, 57344, 1, (4096, 8)),
    (2048, 57344, 1, (8192, 4)), (4096, 57344, 1, (8192, 1)),
    (4096, 32768, 8, (8192, 0)), (8192, 65536, 1, (16384, 0))])
def test_table_plan_gives_the_sums_room_before_a_quarter_load(
        n_real, tile_bytes, min_cols, plan):
    """The widest run sums that fit come first, at load 1/4 where that
    fits too, else 1/2; B2 (min_cols 1) narrows its passes before its hits
    walk, B3 (min_cols 8) does not; with no sums (0 columns), load 1/4
    where it fits beside the ids."""
    assert table_plan(n_real, tile_bytes, 8, min_cols) == plan


def test_table_slots_always_fit_and_stay_at_most_half_full():
    for items in (1, 100, 512, 4096, 8191, 8192):
        for tile_bytes in (_query_tile_bytes(items), 57344):
            tile_bytes = max(tile_bytes, _query_tile_bytes(items))
            for n in range(0, items + 1, max(1, items // 97)):
                for cols, min_cols in ((8, 8), (8, 1), (4, 1), (1, 1)):
                    slots, c = table_plan(n, tile_bytes, cols, min_cols)
                    assert slots & (slots - 1) == 0
                    assert slots >= max(64, 2 * n)
                    assert c == 0 or min_cols <= c <= cols
                    assert (-(-4 * n // 16) * 16 + 2 * slots + 4 * c * n
                            <= tile_bytes)


def test_query_tiles_report_what_the_table_holds():
    carry = (1 << 20) - 1
    mi = np.array([3, 3, 5, (1 << 20) + 3, -2, -2], np.int32)
    assert query_tiles(mi, carry) == [{
        "items": 6, "sorted": True, "real": 4, "distinct": 2, "slots": 64,
        "sum_cols": 0}]
    assert query_tiles(mi, carry, min_cols=1)[0]["sum_cols"] == 1
    assert query_tiles(mi, carry, tile_bytes=4096)[0]["sum_cols"] == 8
    unsorted = query_tiles(mi[::-1].copy(), carry)[0]
    assert unsorted["sorted"] is False and unsorted["slots"] is None
    assert query_tiles(np.empty(0, np.int32), carry) == [{
        "items": 0, "sorted": True, "real": 0, "distinct": 0, "slots": 64,
        "sum_cols": 8}]
    tiles = query_tiles(np.arange(20000, dtype=np.int32), (1 << 19) - 1)
    assert [t["items"] for t in tiles] == [8192, 8192, 3616]
    assert [t["slots"] for t in tiles] == [16384, 16384, 16384]
    assert [t["sum_cols"] for t in tiles] == [0, 0, 0]


def test_query_tiles_count_every_nonnegative_id_in_b1s_table():
    """B1's ELL ids carry any int32, so its table (MAX_KEY) holds every
    real id of the tile, 2^20 and above and 2^31 - 1 included; B2's holds
    those below 2^20, B3's those up to 2^19 - 1."""
    big = [(1 << 19) + 1, 1 << 20, (1 << 20) + 3, (1 << 30) + 7, MAX_KEY]
    mi = np.array([3, 3, 5] + big + [big[-1], -2, -2], np.int32)
    assert MAX_KEY == np.iinfo(np.int32).max
    tile = query_tiles(mi, MAX_KEY, min_cols=4)[0]
    assert (tile["items"], tile["real"], tile["distinct"]) == (11, 9, 7)
    assert query_tiles(mi, (1 << 20) - 1)[0]["distinct"] == 3
    assert query_tiles(mi, (1 << 19) - 1)[0]["distinct"] == 2
    assert tile["sorted"] and tile["slots"] == 64


def _wide_ids(seed):
    """_adversarial_case with its ids mapped, in order, onto ids that no
    packed word carries: 2^20 and above, up to 2^31 - 1, with low bits
    that collide with the small ids. The map keeps the stream sorted and
    the scores unchanged."""
    ids, vals, mi, mv = _adversarial_case(seed)
    # the largest id (2^31 - 1 once mapped) in a doc and in the stream
    d = int(np.flatnonzero((ids >= 0).any(1))[0])
    ids[d, (ids[d] >= 0).sum() - 1] = VOCAB - 1
    mi[max(0, (mi >= 0).sum() - 1)] = VOCAB - 1
    rng = np.random.default_rng(seed)
    wide = np.sort(np.concatenate([
        [1 << 20, (1 << 20) + 1, MAX_KEY - 1, MAX_KEY],
        rng.choice(np.arange(1 << 20, MAX_KEY - 1, 1 << 20), VOCAB - 4,
                   replace=False) + rng.integers(0, VOCAB, VOCAB - 4)]))
    assert np.unique(wide).size == VOCAB
    remap = lambda a: np.where(a < 0, a, wide[np.maximum(a, 0)]).astype(
        np.int32)
    return (ids, remap(ids)), vals, (mi, remap(mi)), mv


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_ell_ids_at_and_above_2_20_like_the_reference(seed):
    """Doc and query ids of 2^20 and above, and 2^31 - 1, which B1 holds
    in its table (B2 and B3 cannot carry them): the port's ``gpu``
    backend scores them as the Pallas kernel in interpret mode does, bit
    for bit, and as the same case with small ids."""
    (ids, wide_ids), vals, (mi, wide_mi), mv = _wide_ids(seed)
    assert wide_ids.max() == wide_mi.max() == MAX_KEY
    got = _port_corr("gpu", wide_ids, vals, wide_mi, mv)
    np.testing.assert_array_equal(
        got, _jax_corr("pallas", wide_ids, vals, wide_mi, mv))
    np.testing.assert_array_equal(got, _port_corr("gpu", ids, vals, mi, mv))


def test_ell_value_that_is_not_finite_scores_nan_on_a_miss():
    """A real slot whose value is inf or NaN adds value x 0 = NaN where
    its id misses the stream (rows 0 and 1), as the Pallas kernel's
    doc_vals x matched does. A pad slot adds nothing whatever its value
    (row 2), where the Pallas kernel's product adds NaN too: the port
    keeps to "pads never match". The CUDA kernel is held to the same
    plain version on the card."""
    ids = np.array([[1, 2, -1], [3, 2, -1], [4, 1, -1]], np.int32)
    vals = np.array([[np.inf, 1, 5], [np.nan, np.inf, 5], [2, 1, np.inf]],
                    np.float32)
    mi = np.array([1, 4, -2, -2], np.int32)
    mv = np.array([[1, 0], [0, 2], [0, 0], [0, 0]], np.float32)
    got = _port_corr("gpu", ids, vals, mi, mv)
    want = np.array([[np.inf, np.nan], [np.nan, np.nan], [1, 4]], np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:2],
                                  _jax_corr("pallas", ids, vals, mi, mv)[:2])


@pytest.mark.parametrize("jb,tb", PAIRS[1:])
@pytest.mark.parametrize("seed", [21, 22])
def test_uncarried_query_ids_match_nothing_like_the_reference(jb, tb, seed):
    """Query ids of 2^20 and above, which no packed word carries, with the
    low bits of ids the docs hold: the plain versions score them as the
    Pallas kernels do (not at all)."""
    ids, vals, mi, mv = _adversarial_case(seed)
    real = np.flatnonzero(mi >= 0)
    mi = mi.copy()
    mi[real[::2]] += 1 << 20
    order = np.argsort(np.where(mi < 0, 1 << 40, mi.astype(np.int64)),
                       kind="stable")  # pads last
    mi, mv = mi[order], mv[order]
    np.testing.assert_array_equal(_port_corr(tb, ids, vals, mi, mv),
                                  _jax_corr(jb, ids, vals, mi, mv))


def test_fused_crafted_tiles_and_uncarried_ids_like_the_reference():
    """Tiles the fused kernel must read word by word: pads between rows
    and inside them, an all-pad tile, a tile with more headers than
    block_docs; and query ids above 2^19 - 1, which no fused word
    carries. Per-tile candidates match the Pallas kernel bit for bit."""
    bd, nnz_pad, pad = 8, 6, np.uint32(0xFFFFFFFF)
    cap = bd * (1 + nnz_pad)
    rng = np.random.default_rng(23)

    def row(doc, n):
        words = (rng.choice(40, n, replace=False).astype(np.uint32) << 12) \
            | rng.integers(1, 30, n).astype(np.uint32)
        return [np.uint32(0x80000000 | doc)] + list(words)

    gaps = [pad, pad] + row(0, 2) + [pad] + row(1, 3) + row(2, 0) + [pad] \
        + row(3, 1)
    gaps.insert(4, pad)                       # a pad inside row 0
    many = sum((row(100 + d, 2) for d in range(bd + 3)), [])
    tiles = np.full((3, cap), pad, np.uint32)
    tiles[0, :len(gaps)] = gaps
    tiles[2, :len(many)] = many
    mi = np.array(list(range(0, 40, 5)) + [5 + (1 << 19), 6 + (1 << 19)]
                  + [-2] * 6, np.int32)
    mv = rng.integers(1, 5, (16, 3)).astype(np.float32)
    qn = np.sqrt((mv ** 2).sum(0)).astype(np.float32)
    jv, ji = j_fused.fused_match_topk(
        *map(jnp.asarray, (tiles, mi, mv, qn)), block_docs=bd, kp=6,
        block_query=8, interpret=True)
    tv, ti = t_fused.fused_match_topk(
        torch.from_numpy(tiles.view(np.int32)),
        *map(torch.from_numpy, (mi, mv, qn)), block_docs=bd, kp=6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti[1] == -1).all()
    assert set(ti[2].flatten().tolist()) <= set(range(100, 100 + bd))
