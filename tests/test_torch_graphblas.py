"""The port's GraphBLAS ops (``repro_torch.core.graphblas``) against the
JAX package's, on the CPU: the four cases of ``tests/test_graphblas.py``,
each fed to both packages from numpy. Sums (``spmv_plus_times``,
``pagerank``) agree within rtol 1e-5, as the reference's own test holds
them to a dense product: torch and XLA sum the K products of a row in
another order. Min, max and counts (``spmv_min_plus``,
``spmv_max_times``, ``out_degree``, ``bfs_levels``) agree exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, strategies as st

from repro.core import graphblas as j_gb
from repro_torch.core import graphblas as gb
from tests.test_graphblas import _random_graph

torch.set_num_threads(2)
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ref(fn, *args, **kw):
    return np.asarray(fn(*(jnp.asarray(a) for a in args), **kw))


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**20), n=st.integers(3, 30), k=st.integers(1, 6))
def test_spmv_semirings_match_the_reference_and_dense(seed, n, k):
    ids, vals, dense = _random_graph(n, k, seed)
    x = np.random.default_rng(seed + 1).standard_normal(n).astype(np.float32)
    got = gb.spmv_plus_times(_t(ids), _t(vals), _t(x)).numpy()
    np.testing.assert_allclose(got, _ref(j_gb.spmv_plus_times, ids, vals, x),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got, dense @ x, rtol=RTOL, atol=1e-5)
    for name in ("spmv_min_plus", "spmv_max_times"):
        np.testing.assert_array_equal(
            getattr(gb, name)(_t(ids), _t(vals), _t(x)).numpy(),
            _ref(getattr(j_gb, name), ids, vals, x))
    np.testing.assert_array_equal(gb.out_degree(_t(ids)).numpy(),
                                  _ref(j_gb.out_degree, ids))


def test_min_plus_is_sssp_relaxation():
    # path graph 0 -> 1 -> 2 -> 3 (incoming lists)
    n = 4
    ids = np.array([[-1], [0], [1], [2]], np.int32)
    vals = np.array([[0.0], [1.0], [2.0], [3.0]], np.float32)
    d = torch.full((n,), float("inf"))
    d[0] = 0.0
    jd = jnp.full((n,), jnp.inf).at[0].set(0.0)
    for _ in range(n):
        d = gb.spmv_min_plus(_t(ids), _t(vals), d)
        jd = j_gb.spmv_min_plus(jnp.asarray(ids), jnp.asarray(vals), jd)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(d.numpy(), [0.0, 1.0, 3.0, 6.0])


@pytest.mark.parametrize("iters", [1, 60])
def test_pagerank_sums_to_one_and_ranks_hub(iters):
    n = 20
    # everyone links to vertex 0 (hub); incoming ELL for vertex 0 is full
    ids_in = np.full((n, n), -1, np.int32)
    out_deg = np.zeros(n, np.int64)
    for s in range(1, n):
        ids_in[0, s - 1] = s
        out_deg[s] = 1
    vals_in = (ids_in >= 0).astype(np.float32)
    pr = gb.pagerank(_t(ids_in), _t(vals_in), _t(out_deg),
                     iters=iters).numpy()
    want = _ref(j_gb.pagerank, ids_in, vals_in, out_deg, iters=iters)
    np.testing.assert_allclose(pr, want, rtol=RTOL)
    np.testing.assert_allclose(pr.sum(), 1.0, rtol=1e-3)
    assert pr[0] == pr.max()


def test_pagerank_on_a_random_graph_with_dangling_vertices():
    """Uniform in-neighbours (the chip run's graph, small), so some
    vertices have no out-edge and their mass is redistributed."""
    n, m = 64, 256
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    order = np.argsort(dst, kind="stable")
    indeg = np.bincount(dst, minlength=n)
    ids = np.full((n, indeg.max()), -1, np.int32)
    pos = np.arange(m) - np.repeat(np.cumsum(indeg) - indeg, indeg)
    ids[dst[order], pos] = src[order]
    vals = (ids >= 0).astype(np.float32)
    out_deg = np.bincount(src, minlength=n)
    assert (out_deg == 0).any()
    pr = gb.pagerank(_t(ids), _t(vals), _t(out_deg)).numpy()
    np.testing.assert_allclose(
        pr, _ref(j_gb.pagerank, ids, vals, out_deg), rtol=RTOL)
    np.testing.assert_allclose(pr.sum(), 1.0, rtol=1e-3)
    levels = gb.bfs_levels(_t(ids), src=0, max_iters=8).numpy()
    np.testing.assert_array_equal(
        levels, _ref(lambda a: j_gb.bfs_levels(a, src=0, max_iters=8), ids))


@pytest.mark.parametrize("max_iters", [0, 3, 6])
def test_bfs_levels_path_graph(max_iters):
    n = 6
    # reversed adjacency: row v lists u with edge u->v
    ids = np.full((n, 1), -1, np.int32)
    for v in range(1, n):
        ids[v, 0] = v - 1
    d = gb.bfs_levels(_t(ids), src=0, max_iters=max_iters).numpy()
    want = _ref(lambda a: j_gb.bfs_levels(a, src=0, max_iters=max_iters),
                ids)
    np.testing.assert_array_equal(d, want)
    reach = max_iters or n                     # the default: n iterations
    levels = np.arange(n, dtype=np.float32)
    np.testing.assert_array_equal(
        d, np.where(levels <= reach, levels, np.inf))
