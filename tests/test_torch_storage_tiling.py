"""The port's AutoTiling against the JAX package's, on the CPU: given the
same budget both pick the same doc and query tiles over a grid of
nnz_pad, corpus sizes and L buckets, with one memo entry a bucket; the
default budget's tiles are the ones its derivation names; and a
``gpu_fused`` engine with AutoTiling answers bit for bit as with
FixedTiling and as the reference's ``pallas_fused`` (interpret mode)
with the same tiling."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.paper_search import SearchConfig as JConfig
from repro.core.engine import PatternSearchEngine as JEngine
from repro.distributed.meshctx import single_device_ctx
from repro.kernels import tiling as j_tiling
from repro.serve.api import Query as JQuery
from repro_torch.configs.paper_search import SearchConfig
from repro_torch.core import corpus as t_corpus
from repro_torch.core.engine import PatternSearchEngine
from repro_torch.kernels import tiling as t_tiling
from repro_torch.serve import Query

torch.set_num_threads(2)
BUDGETS = [4096, 64 * 1024, t_tiling.DEFAULT_SMEM_BUDGET,
           j_tiling.DEFAULT_VMEM_BUDGET]


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("block_docs,block_query", [(128, 512), (1024, 384),
                                                    (16, 32)])
def test_auto_tiling_picks_the_reference_tiles(budget, block_docs,
                                               block_query):
    t = t_tiling.AutoTiling(block_docs, block_query, smem_budget=budget)
    j = j_tiling.AutoTiling(block_docs, block_query, vmem_budget=budget)
    for nnz_pad in (1, 16, 64, 128, 256, 512, 2048):
        for n_docs in (1, 5, 64, 1000, 1 << 20):
            assert t.doc_tile(nnz_pad=nnz_pad, n_docs=n_docs) == \
                j.doc_tile(nnz_pad=nnz_pad, n_docs=n_docs), (nnz_pad, n_docs)
    buckets = [1, 2, 4, 8, 16, 64, 512, 8, 4, 1]
    assert [t.query_tile(Lp) for Lp in buckets] == \
        [j.query_tile(Lp) for Lp in buckets]
    # one memo entry a bucket, as the reference keeps
    assert t.bucket_shapes == j.bucket_shapes
    assert len(t.bucket_shapes) == len(set(buckets))


def test_default_budget_gives_the_derived_tiles():
    """The tiles DEFAULT_SMEM_BUDGET's derivation names: at nnz_pad 128
    the config's 128 rows, narrower for denser corpora, each a tile B3
    stages whole in shared memory (checked on the card by
    tests/test_torch_cuda.py and chip_smoke.py)."""
    t = t_tiling.AutoTiling(1024, 512)
    picks = {n: t.doc_tile(nnz_pad=n, n_docs=1 << 20)
             for n in (64, 128, 256, 512)}
    assert picks == {64: 256, 128: 128, 256: 64, 512: 32}
    for nnz_pad, bd in picks.items():
        assert 4 * bd * (1 + nnz_pad + 8) <= t.smem_budget // 2
    assert all(t.query_tile(Lp) == 512 for Lp in (1, 2, 4, 8))
    assert t_tiling.AutoTiling(128, 512).doc_tile(nnz_pad=64,
                                                  n_docs=1 << 20) == 128
    with pytest.raises(ValueError):
        t_tiling.AutoTiling(128, 512, smem_budget=1024)


CASES = {
    # AutoTiling's rule gives 8-row tiles: kp = min(top_k, 8) = 8 < top_k
    "8-row tiles": (dict(vocab_size=512, avg_nnz_per_doc=14, nnz_pad=32,
                         top_k=16, block_docs=64, block_query=32), 4096, 8),
    # the default budget at nnz_pad 512: 32-row tiles
    "nnz_pad 512": (dict(vocab_size=2048, avg_nnz_per_doc=300, nnz_pad=512,
                         top_k=8, block_docs=128, block_query=512),
                    t_tiling.DEFAULT_SMEM_BUDGET, 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_engine_with_auto_tiling_matches_fixed_and_reference(case):
    widths, budget, want_bd = CASES[case]
    cfg = SearchConfig(name="auto", max_query_nnz=64, **widths)
    jcfg = JConfig(name="auto", max_query_nnz=64, **widths)
    corpus = t_corpus.synthesize(200, cfg.vocab_size, cfg.avg_nnz_per_doc,
                                 cfg.nnz_pad, seed=9)
    auto = PatternSearchEngine(corpus, cfg, "cpu", "gpu_fused",
                               tiling=t_tiling.AutoTiling(
                                   cfg.block_docs, cfg.block_query,
                                   smem_budget=budget))
    fixed = PatternSearchEngine(corpus, cfg, "cpu", "gpu_fused")
    ref = JEngine(corpus, jcfg, single_device_ctx(), "pallas_fused",
                  tiling=j_tiling.AutoTiling(
                      jcfg.block_docs, jcfg.block_query, vmem_budget=budget))
    assert auto._block_docs == ref._block_docs == want_bd
    assert fixed._block_docs == cfg.block_docs
    assert auto.slab_fmt == f"fused:{want_bd}" != fixed.slab_fmt
    rng = np.random.default_rng(1)
    for L in (1, 3, 8):
        idx = rng.integers(0, corpus.n_docs, L)
        qs = [t_corpus.make_query(corpus, int(i), cfg.max_query_nnz)
              for i in idx]
        qi = np.stack([q[0] for q in qs])
        qv = np.stack([q[1] for q in qs])
        got = auto.search_typed(Query(qi, qv))
        for other in (fixed.search_typed(Query(qi, qv)),
                      ref.search_typed(JQuery(qi, qv))):
            np.testing.assert_array_equal(got.doc_ids, other.doc_ids)
            np.testing.assert_array_equal(got.scores.view(np.uint32),
                                          other.scores.view(np.uint32))
        np.testing.assert_array_equal(got.doc_ids[:, 0], idx)
    assert auto.tiling.bucket_shapes == ref.tiling.bucket_shapes
    assert dataclasses.is_dataclass(t_tiling.TileShape(8, 8))
