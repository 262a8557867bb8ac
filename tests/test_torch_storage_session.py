"""The port's FlashSearchSession against the JAX package's, on the CPU,
over the four backend pairs (jnp/torch, pallas/gpu, pallas_packed/
gpu_packed, pallas_fused/gpu_fused; the reference's Pallas kernels in
interpret mode): both open the same store directory and take the same
query arrays. With integral counts the doc ids, the scores and their
order must be identical, and so must every ``SearchStats`` field: cold,
warm, filtered, evicting, approx, auto and memo queries. Also the
ROADMAP C11 repair: a ``gpu`` and a ``gpu_packed`` session may share one
slab cache."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.paper_search import smoke as j_smoke
from repro.serve.api import Query as JQuery
from repro.serve.api import QueryOptions as JOptions
from repro.storage import FlashSearchSession as JSession
from repro.storage import FlashStore as JStore
from repro_torch.configs.paper_search import smoke
from repro_torch.serve import Query, QueryOptions
from repro_torch.storage import FlashSearchSession, FlashStore, SlabCache
from repro_torch.storage.slabcache import slab_nbytes

torch.set_num_threads(2)
PAIRS = [("jnp", "torch"), ("pallas", "gpu"),
         ("pallas_packed", "gpu_packed"), ("pallas_fused", "gpu_fused")]
CFG = smoke()
N_TOPICS, PER_TOPIC = 6, 60
BAND = CFG.vocab_size // N_TOPICS


def banded_docs(seed=0):
    """Documents clustered by topic vocabulary band, one topic a segment
    (as examples/flash_search.py builds them), with a few documents
    longer than nnz_pad so truncation shows in the stats."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(N_TOPICS * PER_TOPIC):
        topic = i // PER_TOPIC
        n = 20 if i % 50 == 7 else int(rng.integers(6, 13))
        words = rng.choice(np.arange(topic * BAND, (topic + 1) * BAND), n,
                           replace=False)
        docs.append((i, sorted((int(w), int(rng.integers(1, 30)))
                               for w in words)))
    return docs


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    """A store written by the reference; the port opens the same files."""
    root = str(tmp_path_factory.mktemp("banded") / "store")
    store = JStore.create(root, vocab_size=CFG.vocab_size,
                          docs_per_segment=PER_TOPIC)
    store.append_docs(banded_docs())
    store.close()
    return root


def _rows(docs, idxs, extra=0, seed=0):
    """Self-queries of ``docs[idxs]`` ([L, max_query_nnz], pad -1), each
    with ``extra`` words from all over the vocabulary at count 1."""
    rng = np.random.default_rng(seed)
    qi = np.full((len(idxs), CFG.max_query_nnz), -1, np.int32)
    qv = np.zeros((len(idxs), CFG.max_query_nnz), np.float32)
    for r, i in enumerate(idxs):
        pairs = dict(docs[i][1])
        for w in rng.choice(CFG.vocab_size, extra, replace=False):
            pairs.setdefault(int(w), 1)
        items = sorted(pairs.items())[:CFG.max_query_nnz]
        qi[r, :len(items)] = [w for w, _ in items]
        qv[r, :len(items)] = [c for _, c in items]
    return qi, qv


DOCS = banded_docs()
BROAD = _rows(DOCS, [3, 130, 301], extra=24)
NARROW = _rows(DOCS, [65, 70])


def _sessions(root, jb, tb, **kw):
    return (JSession(JStore.open(root), j_smoke(), backend=jb, **kw),
            FlashSearchSession(FlashStore.open(root), CFG, "cpu", tb, **kw))


def _search(pair, q, options=None):
    j, t = pair
    want = j.search_typed(JQuery(*q), None if options is None
                          else JOptions(**options))
    got = t.search_typed(Query(*q), None if options is None
                         else QueryOptions(**options))
    return got, want


def _same(got, want, label=""):
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids, label)
    np.testing.assert_array_equal(got.scores.view(np.uint32),
                                  want.scores.view(np.uint32), label)


def _same_stats(pair, label=""):
    j, t = pair
    assert dataclasses.asdict(t.last_stats) == \
        dataclasses.asdict(j.last_stats), label
    return t.last_stats


@pytest.mark.parametrize("jb,tb", PAIRS)
def test_cold_warm_and_narrow_queries_match_the_reference(store_dir, jb, tb):
    pair = _sessions(store_dir, jb, tb)
    try:
        cold = _search(pair, BROAD)
        _same(*cold, f"{tb} cold")
        st = _same_stats(pair, f"{tb} cold")
        assert st.cache_misses == st.segments_scored == N_TOPICS
        assert st.docs_scored == len(DOCS) and st.pairs_truncated > 0
        assert list(cold[0].doc_ids[:, 0]) == [3, 130, 301]
        warm = _search(pair, BROAD)
        _same(*warm, f"{tb} warm")
        _same(warm[0], cold[0], f"{tb} warm vs cold")
        st = _same_stats(pair, f"{tb} warm")
        assert st.cache_hits == N_TOPICS and st.cache_misses == 0
        narrow = _search(pair, NARROW)
        _same(*narrow, f"{tb} narrow")
        st = _same_stats(pair, f"{tb} narrow")
        assert st.segments_skipped == N_TOPICS - 1
        assert list(narrow[0].doc_ids[:, 0]) == [65, 70]
        assert dataclasses.asdict(pair[1].cache_stats) == \
            dataclasses.asdict(pair[0].cache_stats)
    finally:
        for s in pair:
            s.close()


@pytest.mark.parametrize("jb,tb", PAIRS)
def test_evicting_budget_matches_the_reference(store_dir, jb, tb):
    probe = FlashSearchSession(FlashStore.open(store_dir), CFG, "cpu", tb)
    probe.search_typed(Query(*NARROW))
    (slab,) = [e.slab for e in probe.slab_cache._entries.values()]
    probe.close()
    budget = 2 * slab_nbytes(slab) + 1           # two slabs fit, not three
    pair = _sessions(store_dir, jb, tb, cache_bytes=budget)
    try:
        for label in ("first", "second"):
            _same(*_search(pair, BROAD), f"{tb} {label}")
            st = _same_stats(pair, f"{tb} {label}")
            assert st.cache_evictions > 0
            assert pair[1].slab_cache.nbytes <= budget
        assert pair[1].slab_cache.nbytes == pair[0].slab_cache.nbytes
    finally:
        for s in pair:
            s.close()


@pytest.mark.parametrize("jb,tb", PAIRS)
def test_approx_and_auto_modes_match_the_reference(store_dir, jb, tb):
    pair = _sessions(store_dir, jb, tb, approx_min_docs=100)
    try:
        approx = _search(pair, BROAD, {"mode": "approx", "candidates": 8})
        _same(*approx, f"{tb} approx")
        st = _same_stats(pair, f"{tb} approx")
        assert st.approx_segments == N_TOPICS
        assert 0 < st.docs_scored < len(DOCS)
        assert list(approx[0].doc_ids[:, 0]) == [3, 130, 301]
        auto = _search(pair, BROAD, {"mode": "auto", "candidates": 8})
        _same(*auto, f"{tb} auto")
        _same(auto[0], approx[0], f"{tb} auto resolves to approx")
        _same_stats(pair, f"{tb} auto")
        recall = _search(pair, NARROW, {"mode": "approx",
                                        "recall_target": 0.9})
        _same(*recall, f"{tb} recall_target")
        _same_stats(pair, f"{tb} recall_target")
    finally:
        for s in pair:
            s.close()


@pytest.mark.parametrize("jb,tb", PAIRS)
def test_memo_hit_matches_the_reference(store_dir, jb, tb):
    pair = _sessions(store_dir, jb, tb, memo_entries=8)
    try:
        first = _search(pair, NARROW)
        _same_stats(pair, f"{tb} memo miss")
        again = _search(pair, NARROW)
        _same(*again, f"{tb} memo hit")
        _same(again[0], first[0], f"{tb} memo hit vs miss")
        st = _same_stats(pair, f"{tb} memo hit")
        assert st.memo_hits == 1
        assert dataclasses.asdict(pair[1].memo_stats) == \
            dataclasses.asdict(pair[0].memo_stats)
    finally:
        for s in pair:
            s.close()


def _alone(root, backend, q):
    with FlashSearchSession(FlashStore.open(root), CFG, "cpu",
                            backend) as sess:
        return sess.search_typed(Query(*q)), dataclasses.asdict(
            sess.last_stats)


def test_gpu_and_gpu_packed_share_one_slab_cache(store_dir):
    """ROADMAP C11: the packed layout has its own slab format, so a cache
    that a gpu session warmed never hands its ELL slabs to gpu_packed
    (the reference's pallas_packed reads a jnp session's slabs there)."""
    store = FlashStore.open(store_dir)
    cache = SlabCache()
    ell = FlashSearchSession(store, CFG, "cpu", "gpu", slab_cache=cache)
    packed = FlashSearchSession(store, CFG, "cpu", "gpu_packed",
                                slab_cache=cache)
    assert ell.engine.slab_fmt == "ell"
    assert packed.engine.slab_fmt == "packed"
    try:
        for sess, backend in ((ell, "gpu"), (packed, "gpu_packed"),
                              (ell, "gpu"), (packed, "gpu_packed")):
            for q in (BROAD, NARROW):
                want, want_stats = _alone(store_dir, backend, q)
                got = sess.search_typed(Query(*q))
                _same(got, want, backend)
                st = dataclasses.asdict(sess.last_stats)
                assert (st.pop("cache_hits") + st.pop("cache_misses")
                        == want_stats.pop("cache_misses"))
                want_stats.pop("cache_hits")
                assert st == want_stats
        assert len(cache) == 2 * N_TOPICS
        assert sess.last_stats.cache_hits == 1
    finally:
        ell.close()
        packed.close()
