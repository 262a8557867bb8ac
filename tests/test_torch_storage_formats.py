"""The port's storage formats and host-side storage parts against the JAX
package's, on the CPU: segment files byte for byte (bitmap and Bloom
filters), stores that each package opens from the other, filter
verdicts, posting candidates and gathers, memo keys, the vectorized
encoder, the prefetcher, the slab cache's device-byte budget and the
planner's verdicts; and the session's surfaces of queues A3, A4 and A6
(ingest, the coalescing service, the telemetry plane), which work now."""
import dataclasses
import filecmp
import os
import threading

import numpy as np
import pytest
import torch

from repro.configs.paper_search import smoke as j_smoke
from repro.core import stream_format as j_sf
from repro.storage import FlashSearchSession as JSession
from repro.storage import FlashStore as JStore
from repro.storage import filter as j_filter
from repro.storage import memo as j_memo
from repro.storage import postings as j_postings
from repro.storage import segment as j_segment
from repro.storage.store import _corpus_docs
from repro_torch.configs.paper_search import smoke
from repro_torch.core import corpus as t_corpus
from repro_torch.core import stream_format as t_sf
from repro_torch.core.engine import DeviceSlab, PatternSearchEngine
from repro_torch.kernels.fused import PackedSlab
from repro_torch.storage import (FlashSearchSession, FlashStore, Prefetcher,
                                 SlabCache)
from repro_torch.storage import filter as t_filter
from repro_torch.storage import memo as t_memo
from repro_torch.storage import postings as t_postings
from repro_torch.storage import segment as t_segment
from repro_torch.storage.slabcache import slab_nbytes

torch.set_num_threads(2)
CFG = smoke()
VOCAB = 4096


def _docs(n, seed, vocab=VOCAB, max_nnz=40):
    """Documents with the format's corners: empty ones, ones longer than
    a page would like, counts past the 12-bit field (saturating)."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        nw = int(rng.integers(0, max_nnz))
        ws = rng.choice(vocab, nw, replace=False)
        docs.append((3 * i + 1, [(int(w), int(rng.integers(1, 5000)))
                                 for w in ws]))
    return docs


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# segments and stores, byte for byte and both ways
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,vocab", [("auto", VOCAB), ("bitmap", VOCAB),
                                        ("bloom", None)])
def test_write_segment_is_byte_identical(tmp_path, kind, vocab):
    docs = _docs(120, seed=1)
    kw = dict(page_items=256, vocab_size=vocab, filter_kind=kind)
    want = j_segment.write_segment(str(tmp_path / "j.rsps"), docs, **kw)
    got = t_segment.write_segment(str(tmp_path / "t.rsps"), docs, **kw)
    assert got == want
    assert _bytes(tmp_path / "t.rsps") == _bytes(tmp_path / "j.rsps")
    stream = t_sf.encode(docs)
    t_segment.write_stream_segment(str(tmp_path / "s.rsps"), stream, **kw)
    assert _bytes(tmp_path / "s.rsps") == _bytes(tmp_path / "j.rsps")
    with t_segment.Segment(str(tmp_path / "j.rsps")) as seg:
        assert seg.vocab_filter.kind == want["filter"]["meta"]["kind"]
        assert seg.docs() == j_sf.decode(stream)


def test_encode_rows_matches_the_documents_encoder():
    corpus = t_corpus.synthesize(300, CFG.vocab_size, CFG.avg_nnz_per_doc,
                                 CFG.nnz_pad, seed=4)
    rng = np.random.default_rng(0)
    ids, vals = corpus.ids.copy(), corpus.vals.copy()
    ids[5] = ids[5][::-1]                         # unsorted row
    ids[6, :3] = ids[6, 0]                        # a repeated word
    vals[7] = 9000.0                              # saturating counts
    vals[8] = vals[8] + rng.random(vals.shape[1]).astype(np.float32)
    doc_ids = corpus.doc_ids.copy()
    doc_ids[9] = -1                               # a pad row
    doc_ids[10] = (1 << 31) - 1
    rows = t_corpus.Corpus(doc_ids, ids, vals, corpus.norms)
    want = j_sf.encode(_corpus_docs(rows))
    np.testing.assert_array_equal(t_sf.encode_rows(doc_ids, ids, vals), want)
    assert t_sf.encode_rows(doc_ids[:0], ids[:0], vals[:0]).size == 0
    for bad in ({"vals": -vals}, {"ids": ids + (1 << 19)},
                {"doc_ids": doc_ids + (1 << 31)}):
        args = {"doc_ids": doc_ids, "ids": ids, "vals": vals, **bad}
        with pytest.raises(ValueError, match="range|negative"):
            t_sf.encode_rows(**args)


@pytest.fixture(scope="module")
def corpus():
    return t_corpus.synthesize(450, CFG.vocab_size, CFG.avg_nnz_per_doc,
                               CFG.nnz_pad, seed=11)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_stores_open_in_the_other_package(tmp_path, corpus, writer):
    kw = dict(vocab_size=CFG.vocab_size, docs_per_segment=100)
    stores = {}
    for name, cls in (("reference", JStore), ("port", FlashStore)):
        stores[name] = cls.create(str(tmp_path / name), **kw)
        stores[name].append_corpus(corpus)
    files = sorted(os.listdir(tmp_path / "reference"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    _, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "reference", tmp_path / "port", files, shallow=False)
    assert not mismatch and not errors
    reader = FlashStore if writer == "reference" else JStore
    other = reader.open(str(tmp_path / writer))
    mine = stores[writer]
    assert [dataclasses.asdict(e) for e in other.entries] == \
        [dataclasses.asdict(e) for e in mine.entries]
    assert dataclasses.asdict(other.stats()) == \
        dataclasses.asdict(mine.stats())
    a, b = other.scan_corpus(CFG.nnz_pad), mine.scan_corpus(CFG.nnz_pad)
    for f in ("doc_ids", "ids", "vals", "norms"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.ids, corpus.ids)
    for s in (other, mine):
        s.close()


# ---------------------------------------------------------------------------
# filters, postings and memo keys
# ---------------------------------------------------------------------------
def test_filter_verdicts_and_hashes_match():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 1 << 62, 1000, dtype=np.int64).astype(np.uint64)
    np.testing.assert_array_equal(t_filter.splitmix64(x),
                                  j_filter.splitmix64(x))
    words = rng.choice(VOCAB, 300, replace=False)
    for kind in ("bitmap", "bloom"):
        jf = j_filter.build_filter(words, vocab_size=VOCAB, kind=kind)
        tf = t_filter.build_filter(words, vocab_size=VOCAB, kind=kind)
        assert tf.to_bytes() == jf.to_bytes() and tf.meta() == jf.meta()
        tf = t_filter.from_meta(jf.meta(), jf.to_bytes())
        for _ in range(20):
            q = rng.integers(-1, VOCAB, (3, 8))
            assert tf.contains_any_probe(t_filter.QueryProbe(q)) == \
                jf.contains_any_probe(j_filter.QueryProbe(q))
            np.testing.assert_array_equal(tf.contains(q[0]),
                                          jf.contains(q[0]))


def test_posting_candidates_and_gathers_match(tmp_path):
    docs = _docs(150, seed=5)
    path = str(tmp_path / "p.rsps")
    j_segment.write_segment(path, docs, vocab_size=VOCAB)
    rng = np.random.default_rng(6)
    with t_segment.Segment(path) as seg:
        jp = j_postings.PostingIndex.build(seg.stream())
        tp = seg.postings
        assert tp.to_bytes() == jp.to_bytes() and tp.meta() == jp.meta()
        back = j_postings.PostingIndex.from_bytes(tp.meta(), tp.to_bytes())
        np.testing.assert_array_equal(back.postings, tp.postings)
        for n_cand in (1, 7, 40, 500):
            qi = rng.integers(-1, VOCAB, (4, 24)).astype(np.int32)
            qv = rng.integers(1, 9, (4, 24)).astype(np.float32)
            pool = tp.candidates(qi, qv, n_cand)
            np.testing.assert_array_equal(pool, jp.candidates(qi, qv, n_cand))
            with j_segment.Segment(path) as jseg:
                want = j_postings.gather_rows(jseg, pool, 16)
            got = t_postings.gather_rows(seg, pool, 16)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_memo_keys_match():
    rng = np.random.default_rng(7)
    qi = rng.integers(-1, VOCAB, (3, 12)).astype(np.int32)
    qv = rng.integers(1, 9, (3, 12)).astype(np.float32)
    assert t_memo.query_fingerprint(qi, qv) == \
        j_memo.query_fingerprint(qi, qv)
    args = (1, (0, None), "ell", 16, "exact", 64, qi, qv)
    assert t_memo.memo_key(*args) == j_memo.memo_key(*args)


def test_planner_verdicts_match(tmp_path):
    root = str(tmp_path / "s")
    store = JStore.create(root, vocab_size=CFG.vocab_size,
                          docs_per_segment=50)
    rng = np.random.default_rng(8)
    store.append_docs([(i, sorted((int(w), 2) for w in rng.choice(
        np.arange(64 * (i // 50), 64 * (i // 50) + 64), 6, replace=False)))
        for i in range(400)])
    j = JSession(store, j_smoke())
    t = FlashSearchSession(FlashStore.open(root), CFG, "cpu")
    for cols in ([3, 70], [130, 131, 500], [-1]):
        qi = np.array([cols], np.int32)
        jp, tp = j._planner.plan(j.store, qi), t._planner.plan(t.store, qi)
        assert tp.skipped == jp.skipped
        assert [dataclasses.astuple(s) for s in tp.steps] == \
            [dataclasses.astuple(s) for s in jp.steps]
        assert (tp.slab_docs, tp.mode, tp.filtered) == \
            (jp.slab_docs, jp.mode, jp.filtered)
    j.close()
    t.close()


# ---------------------------------------------------------------------------
# prefetcher and slab cache
# ---------------------------------------------------------------------------
def test_prefetcher_error_surfaces_at_the_consumer_and_close_is_idempotent():
    def load(i):
        if i == 3:
            raise RuntimeError("segment unreadable")
        return i

    pf = Prefetcher(range(10), load, depth=2)
    got = []
    with pytest.raises(RuntimeError, match="segment unreadable"):
        for v in pf:
            got.append(v)
    assert got == [0, 1, 2]
    assert list(pf) == []                   # the stream is over
    pf.close()
    pf.close()
    started = threading.Event()
    pf = Prefetcher(range(1 << 20), lambda i: started.set() or i, depth=2)
    started.wait(timeout=5)
    pf.close()
    pf.close()
    assert not pf._worker.is_alive()


def test_slab_nbytes_counts_device_tensors_and_eviction_follows_it(corpus):
    slabs = []
    for backend in ("gpu", "gpu_packed", "gpu_fused"):
        eng = PatternSearchEngine(None, CFG, "cpu", backend)
        slab = eng.put_slab(corpus.slice_rows(0, 64))
        assert isinstance(slab, PackedSlab if backend == "gpu_fused"
                          else DeviceSlab)
        assert slab_nbytes(slab) == sum(t.numel() * t.element_size()
                                        for t in slab)
        slabs.append(slab)
    ell, packed, fused = slabs
    assert slab_nbytes(ell) == 64 * (2 * CFG.nnz_pad + 2) * 4
    cache = SlabCache(slab_nbytes(ell) + slab_nbytes(fused))
    assert cache.put("a", ell, n_docs=64, n_trunc=0) == 0
    assert cache.put("b", fused, n_docs=64, n_trunc=0) == 0
    assert cache.nbytes == slab_nbytes(ell) + slab_nbytes(fused)
    assert cache.put("c", packed, n_docs=64, n_trunc=0) == 1   # evicts a
    assert cache.keys() == ["b", "c"]
    assert cache.nbytes == slab_nbytes(fused) + slab_nbytes(packed)
    assert SlabCache(16).put("d", ell, n_docs=64, n_trunc=0) == 0


# ---------------------------------------------------------------------------
# what waits for later queue items
# ---------------------------------------------------------------------------
def test_session_refuses_what_waits_for_queues_a3_a4_a6(tmp_path, corpus):
    store = FlashStore.create(str(tmp_path / "s"), vocab_size=CFG.vocab_size,
                              docs_per_segment=200)
    store.append_corpus(corpus)
    sess = FlashSearchSession(store, CFG, "cpu")
    with pytest.raises(RuntimeError, match="enable_ingest"):
        sess.append(1, [(2, 3)])
    assert sess.ingest is None and sess.flush_ingest() == 0
    # A3 (ingest) and A4 (the coalescing service) are ported: both work
    pipe = sess.enable_ingest(auto_compact=False)
    assert sess.enable_ingest() is pipe and sess.ingest is pipe
    assert sess.service() is sess.service()
    row = sess.submit(*t_corpus.make_query(corpus, 0, CFG.max_query_nnz)
                      ).result(timeout=60)
    assert int(row.doc_ids[0]) == int(corpus.doc_ids[0])
    # A6 (the telemetry plane) is ported: one server a session, closed
    # with it
    srv = sess.start_telemetry()
    assert sess.start_telemetry() is srv and sess.telemetry is srv
    assert srv.healthz()[0] == "ok"
    sess.close()
    assert sess.telemetry is None
    sess.close()
    with pytest.raises(RuntimeError, match="closed"):
        sess.service()
