"""The slab cache's invalidation under writes, folds and compaction, port
against reference on one op sequence, on the CPU (the jnp/torch pair).

Each scenario runs once in each package, each on its own copy of the
same store (the same bytes), and the two runs must agree: results (doc
ids and the scores' bits), ``SearchStats``, and what the cache holds.
The scenarios are those of ``tests/test_plan_cache.py`` that reach the
fold's and the compaction's cache invalidation (warm equals cold on an
ingest snapshot, on a cluster and through ``submit``; compaction drops
the replaced names; admission is gated on the plan's generation; a
snapshot outlived by a fold never readmits), and the property test of
``tests/test_cache_property.py``, which here compares port and reference
on the same op sequence rather than a live store with a fresh one,
because results depend on segment layout (ROADMAP C1)."""
import dataclasses
import shutil
import tempfile

import numpy as np
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro import cluster as j_cluster
from repro.configs.paper_search import smoke as j_smoke
from repro.core import corpus as j_corpus
from repro.serve.api import Query as JQuery
from repro.storage import FlashSearchSession as JSession
from repro.storage import FlashStore as JStore
from repro.storage import SlabCache as JCache
from repro.storage import plan as j_plan
from repro.storage.session import SearchStats as JStats
from repro.storage.store import _corpus_docs
from repro_torch import cluster as t_cluster
from repro_torch.configs.paper_search import smoke
from repro_torch.serve import Query
from repro_torch.storage import FlashSearchSession, FlashStore, SlabCache
from repro_torch.storage import plan as t_plan
from repro_torch.storage.session import SearchStats

torch.set_num_threads(2)
CFG = smoke()
CORPUS = j_corpus.synthesize(400, CFG.vocab_size, CFG.avg_nnz_per_doc,
                             CFG.nnz_pad, seed=11)
DOCS = _corpus_docs(CORPUS)


@dataclasses.dataclass(frozen=True)
class Side:
    """One package's storage surface: the reference's or the port's."""
    port: bool

    @property
    def Store(self):
        return FlashStore if self.port else JStore

    @property
    def Cache(self):
        return SlabCache if self.port else JCache

    @property
    def plan(self):
        return t_plan if self.port else j_plan

    @property
    def Stats(self):
        return SearchStats if self.port else JStats

    def session(self, store, **kw):
        if self.port:
            return FlashSearchSession(store, CFG, "cpu", "torch", **kw)
        return JSession(store, j_smoke(), backend="jnp", **kw)

    def cluster_session(self, root):
        if self.port:
            return t_cluster.FlashClusterSession(root, CFG, device="cpu",
                                                 backend="torch")
        return j_cluster.FlashClusterSession(root, j_smoke())

    def search(self, sess, qi, qv):
        return sess.search_typed((Query if self.port else JQuery)(qi, qv))

    def build(self, root, n, docs_per_segment=100):
        store = self.Store.create(str(root), vocab_size=CFG.vocab_size,
                                  docs_per_segment=docs_per_segment)
        store.append_docs(DOCS[:n])
        return store


SIDES = (Side(False), Side(True))


def _queries(idxs):
    qs = [j_corpus.make_query(CORPUS, i, CFG.max_query_nnz) for i in idxs]
    return np.stack([q[0] for q in qs]), np.stack([q[1] for q in qs])


def _result(res):
    return (np.asarray(res.doc_ids).tolist(),
            np.asarray(res.scores).view(np.uint32).tolist())


def _each(tmp_path, scenario):
    """``scenario(side, tmp_dir)`` once a package; equal observations.
    Returns the port's."""
    out = []
    for side in SIDES:
        d = tmp_path / ("port" if side.port else "ref")
        d.mkdir()
        out.append(scenario(side, d))
    assert out[0] == out[1]
    return out[1]


def test_warm_equals_cold_on_an_ingest_snapshot(tmp_path):
    """Base segments, a sealed delta and a memtable, warm and cold; then
    a seal and a fold, and the warm path again."""
    def scenario(side, d):
        sess = side.session(side.build(d / "live", 300, 64))
        sess.enable_ingest(seal_docs=40, fold_min_segments=2,
                           auto_compact=False)
        for doc, pairs in DOCS[300:360]:
            sess.append(doc, pairs)
        qi, qv = _queries([5, 320])
        cold = _result(side.search(sess, qi, qv))
        cold_st = dataclasses.asdict(sess.last_stats)
        warm = _result(side.search(sess, qi, qv))
        warm_st = dataclasses.asdict(sess.last_stats)
        sess.flush_ingest()
        folded = sess.ingest.compact_once()
        after = _result(side.search(sess, qi, qv))
        after_st = dataclasses.asdict(sess.last_stats)
        inv = sess.slab_cache.stats.invalidations
        sess.close()
        return cold, warm, after, cold_st, warm_st, after_st, folded, inv

    cold, warm, after, _, warm_st, _, folded, inv = _each(tmp_path, scenario)
    assert cold == warm == after
    assert warm_st["cache_hits"] > 0 and warm_st["memtable_docs"] == 60 % 40
    assert folded > 0 and inv > 0


def test_warm_equals_cold_on_a_cluster(tmp_path):
    root = str(tmp_path / "cluster")
    j_cluster.build_sharded_store(root, DOCS, n_shards=3, replicas=1,
                                  vocab_size=CFG.vocab_size,
                                  docs_per_segment=64)
    qi, qv = _queries([9, 200, 377])
    out = []
    for side in SIDES:
        with side.cluster_session(root) as cs:
            cold = _result(side.search(cs, qi, qv))
            cold_hits = cs.last_stats.cache_hits
            warm = _result(side.search(cs, qi, qv))
            agg = cs.last_stats
            shared = all(s.slab_cache is cs.slab_cache
                         for s in cs.router._open_sessions())
            out.append((cold, warm, cold_hits, agg.cache_hits,
                        agg.segments_scored, agg.cache_misses,
                        agg.cache_hit_rate, cs.cache_stats.hits,
                        len(cs.router._open_sessions()), shared))
    assert out[0] == out[1]
    cold, warm, cold_hits, hits, scored, misses, rate, _, n, shared = out[1]
    assert cold == warm and cold_hits == 0 and hits == scored > 0
    assert misses == 0 and rate == 1.0 and n == 3 and shared


def test_warm_equals_cold_through_submit(tmp_path):
    def scenario(side, d):
        sess = side.session(side.build(d / "s", 400))
        q = j_corpus.make_query(CORPUS, 77, CFG.max_query_nnz)
        first = sess.submit((Query if side.port else JQuery)(*q)).result()
        again = sess.submit((Query if side.port else JQuery)(*q)).result()
        hits = (sess.last_stats.cache_hits, sess.cache_stats.hits)
        sess.close()
        return _result(first), _result(again), hits

    first, again, (hits, lifetime) = _each(tmp_path, scenario)
    assert first == again and hits > 0 and lifetime > 0


def test_compact_invalidates_the_replaced_names(tmp_path):
    def scenario(side, d):
        store = side.build(d / "s", 130, 40)     # 4 segments, last underfull
        sess = side.session(store)
        qi, qv = _queries([10])
        before = _result(side.search(sess, qi, qv))
        cached = len(sess.slab_cache)
        gen = store.generation
        store.compact()
        seen = (store.generation - gen, len(sess.slab_cache),
                sess.slab_cache.stats.invalidations)
        after = _result(side.search(sess, qi, qv))
        hits = sess.last_stats.cache_hits
        sess.close()
        return before, after, cached, seen, hits

    before, after, cached, (bump, left, inv), hits = _each(tmp_path,
                                                           scenario)
    assert before == after and cached > 0
    assert bump == 1 and left == 0 and inv > 0 and hits == 0


def test_admission_is_gated_on_the_plan_generation(tmp_path):
    def scenario(side, d):
        store = side.build(d / "s", 400)
        sess = side.session(store)
        qi, qv = _queries([12])
        plan = sess._planner.plan(store, qi)
        store.bump_generation()                  # a fold/compact commits
        stats = side.Stats(segments_total=plan.segments_total,
                           segments_skipped=len(plan.skipped),
                           segments_scored=len(plan.steps))
        stale = _result(side.plan.execute_plan(
            sess.engine, store, plan, qi, qv, stats=stats,
            cache=sess.slab_cache))
        admitted_stale = len(sess.slab_cache)
        fresh = _result(side.search(sess, qi, qv))
        admitted = len(sess.slab_cache)
        sess.close()
        return stale, fresh, admitted_stale, admitted

    stale, fresh, admitted_stale, admitted = _each(tmp_path, scenario)
    assert stale == fresh and admitted_stale == 0 and admitted > 0


def test_a_snapshot_outlived_by_a_fold_never_readmits(tmp_path):
    def scenario(side, d):
        sess = side.session(side.build(d / "live", 200, 16))
        pipe = sess.enable_ingest(seal_docs=8, fold_min_segments=2,
                                  auto_compact=False)
        for doc, pairs in DOCS[200:230]:
            sess.append(doc, pairs)
        sess.flush_ingest()
        snap = pipe.capture()
        folded = pipe.compact_once()             # a fold lands mid-query
        moved = snap.generation != snap.live_generation
        qi, qv = _queries([3, 210])
        got = _result(sess._search_view(snap, snap, qi, qv))
        snap.close()
        admitted_stale = len(sess.slab_cache)
        fresh = _result(side.search(sess, qi, qv))
        admitted = len(sess.slab_cache)
        sess.close()
        return got, fresh, folded, moved, admitted_stale, admitted

    got, fresh, folded, moved, admitted_stale, admitted = _each(tmp_path,
                                                                scenario)
    assert got == fresh and folded > 0 and moved
    assert admitted_stale == 0 and admitted > 0


# ---------------------------------------------------------------------------
# property: any interleaving with a cache that evicts, on one op sequence
# ---------------------------------------------------------------------------
_POOL = _corpus_docs(j_corpus.synthesize(120, CFG.vocab_size,
                                         CFG.avg_nnz_per_doc, CFG.nnz_pad,
                                         seed=43))
_OP = st.sampled_from(["append", "append", "append", "append", "append",
                       "append", "seal", "compact", "search", "crash"])


def _run_ops(side, root, ops):
    """The reference property test's loop (tests/test_cache_property.py)
    on one package, with ~3 slabs of cache; returns each search's cold
    and warm results and stats, and the cache's end state."""
    cache = side.Cache(max_bytes=3 * 8 * (CFG.nnz_pad * 8 + 8) + 256)

    def live(created):
        store = side.Store.open(root) if created else side.Store.create(
            root, vocab_size=CFG.vocab_size, docs_per_segment=8)
        sess = side.session(store, slab_cache=cache)
        sess.enable_ingest(seal_docs=6, fold_min_segments=2,
                           auto_compact=False)
        return sess

    sess = live(False)
    out = []
    appended = []
    nxt = iter(_POOL)
    try:
        for op in ops + ["search"]:
            if op == "append":
                d, p = next(nxt)
                sess.append(d, p)
                appended.append((d, p))
            elif op == "seal":
                sess.flush_ingest()
            elif op == "compact":
                sess.ingest.compact_once()
            elif op == "crash":
                sess.ingest.close(seal=False)
                sess.store.close()
                sess = live(True)
            elif op == "search":
                probe = appended[-1] if appended else _POOL[0]
                qi = np.full((1, CFG.max_query_nnz), -1, np.int32)
                qv = np.zeros((1, CFG.max_query_nnz), np.float32)
                for j, (w, c) in enumerate(probe[1][:CFG.max_query_nnz]):
                    qi[0, j] = w
                    qv[0, j] = c
                for _ in range(2):               # cold-ish, then warm
                    out.append((_result(side.search(sess, qi, qv)),
                                dataclasses.asdict(sess.last_stats)))
        assert cache.nbytes <= cache.max_bytes
        out.append((len(cache), dataclasses.asdict(cache.stats)))
    finally:
        sess.close()
    return out


@settings(max_examples=3, deadline=None, derandomize=True, database=None)
@given(ops=st.lists(_OP, min_size=4, max_size=20))
@example(ops=["append"] * 4 + ["seal", "append"])            # ROADMAP C1
@example(ops=["append"] * 7 + ["seal", "compact", "search", "crash",
                                "append", "search"])
def test_any_interleaving_with_an_evicting_cache_matches_the_reference(ops):
    tmp = tempfile.mkdtemp(prefix="torch-cache-prop-")
    try:
        ref, port = (_run_ops(side, f"{tmp}/{int(side.port)}", list(ops))
                     for side in SIDES)
        assert port == ref
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
