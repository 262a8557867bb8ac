"""The port's top-k primitives against ``repro.core.topk`` and the engine's
cross-slab merge: tie order (lower index first), non-finite ranking (the
floats' total order: NaN above +inf, -NaN below -inf, -0.0 below +0.0),
padding rows and short candidate lists."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topk as j_topk
from repro.core.engine import SearchResult as JResult
from repro.core.engine import _merge_results as j_merge
from repro_torch.core import topk as t_topk
from repro_torch.core.engine import SearchResult as TResult
from repro_torch.core.engine import _merge_results as t_merge

torch.set_num_threads(2)
NEG_NAN = np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0]


def _scores(seed, D, L):
    """Scores drawn from a small set, so ties are everywhere, with +NaN,
    -NaN, +-inf and +-0.0 mixed in."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.5, 0.25, 0.0, -0.0, 1.0, np.inf, -np.inf, np.nan,
                     NEG_NAN, 0.5], np.float32)
    return pool[rng.integers(0, pool.size, (D, L))]


def _eq(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32) if got.dtype ==
                                  np.float32 else got,
                                  want.view(np.uint32) if want.dtype ==
                                  np.float32 else want)


@pytest.mark.parametrize("seed,D,L,k", [(0, 9, 3, 4), (1, 20, 2, 20),
                                        (2, 3, 4, 7)])
def test_local_topk_matches_reference(seed, D, L, k):
    scores = _scores(seed, D, L)
    doc_ids = np.arange(D, dtype=np.int32) + 100
    doc_ids[::4] = -1                                   # padding rows
    tv, ti = t_topk.local_topk(torch.from_numpy(scores),
                               torch.from_numpy(doc_ids), k)
    jv, ji = j_topk.local_topk(jnp.asarray(scores), jnp.asarray(doc_ids), k)
    _eq(tv.numpy(), jv)
    _eq(ti.numpy(), ji)
    assert ti.dtype == torch.int32


@pytest.mark.parametrize("seed,C,k", [(3, 12, 5), (4, 3, 6)])
def test_fold_and_merge_topk_match_reference(seed, C, k):
    vals = _scores(seed, 2, C)
    ids = np.arange(2 * C, dtype=np.int32).reshape(2, C)
    tv, ti = t_topk.fold_topk(torch.from_numpy(vals), torch.from_numpy(ids), k)
    jv, ji = j_topk.fold_topk(jnp.asarray(vals), jnp.asarray(ids), k)
    _eq(tv.numpy(), jv)
    _eq(ti.numpy(), ji)
    tv, ti = t_topk.merge_topk(torch.from_numpy(vals), torch.from_numpy(ids),
                               torch.from_numpy(vals[::-1].copy()),
                               torch.from_numpy(ids[::-1].copy()), k)
    jv, ji = j_topk.merge_topk(jnp.asarray(vals), jnp.asarray(ids),
                               jnp.asarray(vals[::-1]), jnp.asarray(ids[::-1]),
                               k)
    _eq(tv.numpy(), jv)
    _eq(ti.numpy(), ji)


def test_rank_order_is_total_order():
    x = np.array([1.0, np.nan, np.inf, 1.0, -np.inf, NEG_NAN, -0.0, 0.0],
                 np.float32)
    _, idx = t_topk.top_k(torch.from_numpy(x)[None], x.size)
    np.testing.assert_array_equal(idx[0].numpy(), [1, 2, 0, 3, 7, 6, 4, 5])
    _, jidx = j_topk.fold_topk(jnp.asarray(x)[None],
                               jnp.arange(x.size)[None], x.size)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(jidx)[0])


@pytest.mark.parametrize("seed", [5, 6])
def test_merge_results_identical(seed):
    rng = np.random.default_rng(seed)

    def cand():
        ids = rng.integers(-1, 12, (3, 6)).astype(np.int64)
        sc = np.round(rng.random((3, 6)), 1).astype(np.float32)
        sc[ids < 0] = -np.inf
        return ids, sc

    (ai, asc), (bi, bsc) = cand(), cand()
    got = t_merge(TResult(ai, asc), TResult(bi, bsc), 5)
    want = j_merge(JResult(ai, asc), JResult(bi, bsc), 5)
    _eq(got.doc_ids, want.doc_ids)
    _eq(got.scores, want.scores)
