"""The port's resident engine against the JAX package's, on the CPU, over
the four backend pairs (jnp/torch, pallas/gpu, pallas_packed/gpu_packed,
pallas_fused/gpu_fused): the same corpus (same seed) and the same query
arrays go through both; with integral counts the doc ids, the scores
and their order must be identical. Also the streaming path, the fused
stream ingest, the launch-key bookkeeping and the launcher."""
import math
import warnings

import numpy as np
import pytest
import torch

from repro.configs.paper_search import smoke as j_smoke
from repro.core import corpus as j_corpus
from repro.core.engine import PatternSearchEngine as JEngine
from repro.core.stream_format import MAX_DOC_ID
from repro.distributed.meshctx import single_device_ctx
from repro_torch.configs.paper_search import smoke
from repro_torch.core import corpus as t_corpus
from repro_torch.core import stream_format as t_sf
from repro_torch.core.engine import PatternSearchEngine
from repro_torch.launch import search as launcher
from repro_torch.serve import Query, QueryOptions, SearchResponse

torch.set_num_threads(2)
PAIRS = [("jnp", "torch"), ("pallas", "gpu"),
         ("pallas_packed", "gpu_packed"), ("pallas_fused", "gpu_fused")]
N_DOCS = 300
SEED = 3


@pytest.fixture(scope="module")
def corpora():
    cfg = smoke()
    args = (N_DOCS, cfg.vocab_size, cfg.avg_nnz_per_doc, cfg.nnz_pad)
    return (j_corpus.synthesize(*args, seed=SEED),
            t_corpus.synthesize(*args, seed=SEED))


@pytest.fixture(scope="module")
def engines(corpora):
    """One engine per (package, backend), built on first use."""
    cache = {}

    def get(jb, tb):
        if (jb, tb) not in cache:
            cache[jb, tb] = (
                JEngine(corpora[0], j_smoke(), single_device_ctx(), jb),
                PatternSearchEngine(corpora[1], smoke(), "cpu", tb))
        return cache[jb, tb]
    return get


def _queries(corpus, L, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, corpus.n_docs, L)
    qs = [t_corpus.make_query(corpus, int(i), smoke().max_query_nnz)
          for i in idx]
    qi = np.stack([q[0] for q in qs]) if L else np.empty((0, 64), np.int32)
    qv = np.stack([q[1] for q in qs]) if L else np.empty((0, 64), np.float32)
    if L >= 3:
        qi[1] = -1                                  # an empty query row
    return idx, qi, qv


def _same(got, want, label=""):
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids, label)
    np.testing.assert_array_equal(got.scores, want.scores, label)
    assert got.doc_ids.dtype == np.int64 and got.scores.dtype == np.float32


@pytest.mark.parametrize("jb,tb", PAIRS)
@pytest.mark.parametrize("L", [0, 1, 3, 5])
def test_resident_search_bit_identical(engines, corpora, jb, tb, L):
    j_eng, t_eng = engines(jb, tb)
    idx, qi, qv = _queries(corpora[1], L, seed=L)
    want = j_eng.search_typed(_jquery(qi, qv))
    got = t_eng.search_typed(Query(qi, qv))
    _same(got, want, f"{tb} L={L}")
    assert got.doc_ids.shape == (L, smoke().top_k)
    for l in range(L):
        if l != 1 or L < 3:                          # row 1 may be empty
            assert got.doc_ids[l, 0] == idx[l]       # self-search


@pytest.mark.parametrize("jb,tb", PAIRS)
def test_streaming_bit_identical(corpora, jb, tb):
    cfg = smoke()
    j_eng = JEngine(None, j_smoke(), single_device_ctx(), jb)
    t_eng = PatternSearchEngine(None, cfg, "cpu", tb)
    _, qi, qv = _queries(corpora[1], 3, seed=9)
    bounds = [(0, 128), (128, 256), (256, N_DOCS)]
    want = j_eng.search_streaming(
        qi, qv, (corpora[0].slice_rows(a, b) for a, b in bounds))
    # host slabs and slabs already on the device, mixed
    slabs = [corpora[1].slice_rows(a, b) for a, b in bounds]
    slabs[1] = t_eng.put_slab(slabs[1])
    got = t_eng.search_streaming(qi, qv, iter(slabs))
    _same(got, want, tb)
    empty = t_eng.search_streaming(qi, qv, iter([]))
    assert (empty.doc_ids == -1).all() and np.isneginf(empty.scores).all()


def test_put_stream_slab_counts_and_scores():
    cfg = smoke()
    rng = np.random.default_rng(19)
    docs = [(d, sorted((int(w), int(rng.integers(1, 30))) for w in
                       rng.choice(cfg.vocab_size, int(rng.integers(0, 30)),
                                  replace=False))) for d in range(40)]
    stream = t_sf.encode(docs)
    j_eng = JEngine(None, j_smoke(), single_device_ctx(), "pallas_fused")
    t_eng = PatternSearchEngine(None, cfg, "cpu", "gpu_fused")
    j_slab, *j_counts = j_eng.put_stream_slab(stream, pad_docs_to=48)
    t_slab, *t_counts = t_eng.put_stream_slab(stream, pad_docs_to=48)
    assert t_counts == j_counts and t_counts[1] > 0     # truncation seen
    np.testing.assert_array_equal(t_slab.tiles.numpy().view(np.uint32),
                                  np.asarray(j_slab.tiles))
    qi = np.array([[w for w, _ in docs[5][1][:8]] + [-1] * 8], np.int32)
    qv = np.where(qi >= 0, 2.0, 0.0).astype(np.float32)
    _same(t_eng.search_streaming(qi, qv, [t_slab]),
          j_eng.search_streaming(qi, qv, [j_slab]))
    staged = PatternSearchEngine(None, cfg, "cpu", "gpu")
    with pytest.raises(ValueError, match="fused"):
        staged.put_stream_slab(stream)


@pytest.mark.parametrize("jb,tb", [PAIRS[0], PAIRS[3]])
def test_compile_stats_are_distinct_launch_keys(corpora, jb, tb):
    """The port's launch keys (Lp, Qp, n_docs) are the reference's trace
    keys, in order, and stay within log2(max_batch) + 1."""
    j_eng = JEngine(corpora[0], j_smoke(), single_device_ctx(), jb)
    t_eng = PatternSearchEngine(corpora[1], smoke(), "cpu", tb)
    max_batch = 8
    for L in list(range(1, max_batch + 1)) + [2, 7]:
        _, qi, qv = _queries(corpora[1], L, seed=L)
        j_eng.search_typed(_jquery(qi, qv))
        t_eng.search_typed(Query(qi, qv))
    got = t_eng.compile_stats
    assert got == j_eng.compile_stats
    assert got["n_traces"] <= math.log2(max_batch) + 1


def test_typed_options_and_positional_shim(engines, corpora):
    _, t_eng = engines("pallas", "gpu")
    _, qi, qv = _queries(corpora[1], 2, seed=4)
    resp = t_eng.search(Query(qi, qv), options=QueryOptions(k=2))
    assert isinstance(resp, SearchResponse)
    assert resp.doc_ids.shape == (2, 2)
    full = t_eng.search(Query(qi, qv))
    np.testing.assert_array_equal(resp.doc_ids, full.doc_ids[:, :2])
    with pytest.warns(DeprecationWarning):
        legacy = t_eng.search(qi, qv)
    _same(legacy, full)


def test_guards_match_reference(corpora):
    """Packed/fused refuse non-integral counts; fused refuses doc id
    2^31-1 (its header aliases the pad word); every backend refuses word
    ids beyond the vocabulary."""
    cfg = smoke()
    c = t_corpus.Corpus(np.array([0, MAX_DOC_ID]),
                        np.array([[3, -1], [4, -1]], np.int32),
                        np.array([[1.5, 0], [2, 0]], np.float32),
                        np.array([1.5, 2], np.float32))
    with pytest.raises(ValueError, match="integral"):
        PatternSearchEngine(c, cfg, "cpu", "gpu_packed")
    c.vals[0, 0] = 1.0
    with pytest.raises(ValueError, match="alias"):
        PatternSearchEngine(c, cfg, "cpu", "gpu_fused")
    c.ids[0, 0] = cfg.vocab_size
    with pytest.raises(ValueError, match="vocab_size"):
        PatternSearchEngine(c, cfg, "cpu", "torch")
    with pytest.raises(ValueError, match="backend"):
        PatternSearchEngine(corpora[1], cfg, "cpu", "pallas")


@pytest.mark.parametrize("backend", ["torch", "gpu", "gpu_packed",
                                     "gpu_fused"])
def test_launcher_main_on_cpu(backend, capsys):
    argv = ["--n-docs", "200", "--vocab", "512", "--avg-nnz", "10",
            "--nnz-pad", "16", "--queries", "3", "--top-k", "4",
            "--backend", backend, "--device", "cpu", "--seed", "2"]
    res = launcher.main(argv)
    corpus = t_corpus.synthesize(200, 512, 10, 16, seed=2)
    idx = np.random.default_rng(2).integers(0, 200, 3)
    qs = [t_corpus.make_query(corpus, int(i), smoke().max_query_nnz)
          for i in idx]
    cfg = smoke().__class__(name="service", vocab_size=512,
                            avg_nnz_per_doc=10, nnz_pad=16, top_k=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = JEngine(j_corpus.synthesize(200, 512, 10, 16, seed=2),
                       _jcfg(cfg), single_device_ctx(), "jnp").search(
            np.stack([q[0] for q in qs]), np.stack([q[1] for q in qs]))
    _same(res, want)
    out = capsys.readouterr().out
    assert out.count("[OK]") == 3 and "on CPU" not in out


def _jcfg(cfg):
    from repro.configs.paper_search import SearchConfig
    return SearchConfig(**{f: getattr(cfg, f) for f in
                           cfg.__dataclass_fields__})


def _jquery(qi, qv):
    from repro.serve.api import Query as JQuery
    return JQuery(qi, qv)
