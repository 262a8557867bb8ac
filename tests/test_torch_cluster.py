"""The port's cluster tier (partitioner, ShardedStore, ShardRouter,
FlashClusterSession) against the JAX package's, on the CPU.

Both packages open the same cluster directory and take the same query
arrays, so both score the same segment layout (ROADMAP C1). With
integral counts the doc ids, the scores' bits and their order must be
identical, and so must every ``ClusterStats`` field, over the four
backend pairs (jnp/torch, pallas/gpu, pallas_packed/gpu_packed,
pallas_fused/gpu_fused; the reference's Pallas kernels in interpret
mode). A cluster is held to a union store only where at least k
documents match, as the reference's own tests do. Directories written
or rebalanced by either package open in the other, and the port's
``corpus=`` route writes the bytes of the ``docs=`` route."""
import dataclasses
import hashlib
import json
import os
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import cluster as j_cluster
from repro.configs.paper_search import smoke as j_smoke
from repro.core import corpus as j_corpus
from repro.serve.api import Query as JQuery
from repro.storage import FlashSearchSession as JSession
from repro.storage import FlashStore as JStore
from repro.storage.store import _corpus_docs
from repro_torch import cluster as t_cluster
from repro_torch.configs.paper_search import smoke
from repro_torch.serve import Query
from repro_torch.storage import FlashSearchSession, FlashStore

torch.set_num_threads(2)
PAIRS = [("jnp", "torch"), ("pallas", "gpu"),
         ("pallas_packed", "gpu_packed"), ("pallas_fused", "gpu_fused")]
CFG = smoke()
CORPUS = j_corpus.synthesize(240, CFG.vocab_size, CFG.avg_nnz_per_doc,
                             CFG.nnz_pad, seed=5)
DOCS = _corpus_docs(CORPUS)


@dataclasses.dataclass(frozen=True)
class Side:
    """One package's cluster surface: the reference's or the port's."""
    port: bool
    backend: str = ""

    @property
    def cl(self):
        return t_cluster if self.port else j_cluster

    def session(self, root, **kw):
        if self.port:
            return t_cluster.FlashClusterSession(
                root, CFG, device="cpu", backend=self.backend or "torch",
                **kw)
        return j_cluster.FlashClusterSession(
            root, j_smoke(), backend=self.backend or "jnp", **kw)

    def query(self, qi, qv):
        return (Query if self.port else JQuery)(qi, qv)


REF, PORT = Side(False), Side(True)


def _queries(idxs, corpus=CORPUS):
    qs = [j_corpus.make_query(corpus, i, CFG.max_query_nnz) for i in idxs]
    return np.stack([q[0] for q in qs]), np.stack([q[1] for q in qs])


def _query_rows(pairs_list, qn=4):
    qi = np.full((len(pairs_list), qn), -1, np.int32)
    qv = np.zeros((len(pairs_list), qn), np.float32)
    for l, pairs in enumerate(pairs_list):
        for j, (w, c) in enumerate(pairs):
            qi[l, j] = w
            qv[l, j] = c
    return qi, qv


def _same(got, want):
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
    np.testing.assert_array_equal(np.asarray(got.scores).view(np.uint32),
                                  np.asarray(want.scores).view(np.uint32))


def _stats(st):
    """Every ClusterStats field and aggregate, per-shard stats as dicts."""
    return {"per_shard": [None if s is None else dataclasses.asdict(s)
                          for s in st.per_shard],
            **{f: getattr(st, f) for f in (
                "failovers", "partial", "shards_missing", "hedges",
                "hedge_wins", "segments_total", "segments_skipped",
                "segments_scored", "docs_scored", "cache_hits",
                "cache_misses", "skip_rate", "cache_hit_rate")}}


def _files(root):
    """sha256 of every file under a cluster directory, by relative path."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = hashlib.sha256(
                open(path, "rb").read()).hexdigest()
    return out


def _graded_docs(n):
    """doc i = {word 0: 1, word i+1: i+2}: query {0} scores strictly
    decrease with i, so the order is tie-free at the top-k tail."""
    return [(i, [(0, 1), (i + 1, i + 2)]) for i in range(n)]


# ---------------------------------------------------------------------------
# partitioners
# ---------------------------------------------------------------------------
@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(ids=st.lists(st.integers(0, 1 << 40), min_size=0, max_size=50),
       n_shards=st.integers(1, 7),
       policy=st.sampled_from(["hash", "range"]))
def test_partitioners_match_the_reference(ids, n_shards, policy):
    ref = j_cluster.make_partitioner(policy, n_shards, doc_ids=ids)
    port = t_cluster.make_partitioner(policy, n_shards, doc_ids=ids)
    arr = np.asarray(ids, np.int64)
    assert port.spec() == ref.spec()
    assert json.dumps(port.spec()) == json.dumps(ref.spec())
    np.testing.assert_array_equal(port.shard_of(arr), ref.shard_of(arr))
    back = t_cluster.from_spec(ref.spec())
    assert back.spec() == ref.spec()
    np.testing.assert_array_equal(back.shard_of(arr), ref.shard_of(arr))


def test_hash_partitioner_over_a_million_sequential_ids():
    ids = np.arange(1 << 20)
    np.testing.assert_array_equal(
        t_cluster.HashPartitioner(4).shard_of(ids),
        j_cluster.HashPartitioner(4).shard_of(ids))


@pytest.mark.parametrize("call", [
    lambda cl: cl.HashPartitioner(4).shard_of([-1]),
    lambda cl: cl.make_partitioner("mod", 4),
    lambda cl: cl.make_partitioner("range", 4),
    lambda cl: cl.HashPartitioner(0),
    lambda cl: cl.RangePartitioner([5, 3]),
    lambda cl: cl.from_spec({"policy": "mod"})])
def test_partitioners_refuse_what_the_reference_refuses(call):
    for cl in (j_cluster, t_cluster):
        with pytest.raises(ValueError):
            call(cl)


# ---------------------------------------------------------------------------
# the directory: written, opened and rebalanced by either package
# ---------------------------------------------------------------------------
BUILD = dict(n_shards=4, replicas=2, vocab_size=CFG.vocab_size,
             docs_per_segment=24)


@pytest.mark.parametrize("policy", ["hash", "range"])
def test_both_packages_and_both_routes_write_the_same_bytes(tmp_path,
                                                            policy):
    """The reference from ``docs=``, the port from ``docs=`` and from
    ``corpus=`` (a corpus with a pad row): the same files, CLUSTER.json
    included."""
    padded = CORPUS.pad_docs_to(CORPUS.n_docs + 3)
    roots = {k: str(tmp_path / k) for k in ("ref", "docs", "corpus")}
    j_cluster.build_sharded_store(roots["ref"], DOCS, policy=policy, **BUILD)
    t_cluster.build_sharded_store(roots["docs"], DOCS, policy=policy,
                                  **BUILD).close()
    t_cluster.build_sharded_store(roots["corpus"], corpus=padded,
                                  policy=policy, **BUILD).close()
    ref = _files(roots["ref"])
    assert "CLUSTER.json" in ref and len(ref) > 9
    assert _files(roots["docs"]) == ref
    assert _files(roots["corpus"]) == ref
    manifest = json.load(open(os.path.join(roots["corpus"], "CLUSTER.json")))
    assert sum(s["n_docs"] for s in manifest["shards"]) == len(DOCS)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_cluster_written_by_either_package_opens_in_the_other(tmp_path,
                                                                writer):
    root = str(tmp_path / "c")
    w, r = (REF, PORT) if writer == "ref" else (PORT, REF)
    w.cl.build_sharded_store(root, DOCS, **BUILD).close()
    opened = r.cl.ShardedStore.open(root)
    assert opened.manifest == json.load(open(os.path.join(root,
                                                          "CLUSTER.json")))
    assert (opened.n_shards, opened.replicas, opened.n_docs) == (4, 2, 240)
    stats = [dataclasses.asdict(s) for s in opened.stats()]
    other = w.cl.ShardedStore.open(root)
    assert stats == [dataclasses.asdict(s) for s in other.stats()]
    a, b = opened.scan_corpus(CFG.nnz_pad), other.scan_corpus(CFG.nnz_pad)
    for f in ("doc_ids", "ids", "vals", "norms"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    opened.close()
    other.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_rebalance_by_either_package_reads_in_the_other(tmp_path, writer):
    """Build with one package, rebalance to 3 range shards x 1 replica
    with the other (stale generations collected), rebalance back with
    the first: every directory and every search agrees with the same
    steps taken by the reference alone."""
    w, r = (REF, PORT) if writer == "ref" else (PORT, REF)
    roots = {k: str(tmp_path / k) for k in ("mixed", "ref")}
    for root, first, second in ((roots["mixed"], w, r),
                                (roots["ref"], REF, REF)):
        first.cl.build_sharded_store(root, DOCS, **BUILD).close()
        os.makedirs(os.path.join(root, "gen-007", "shard-00"))
        second.cl.rebalance(root, n_shards=3, policy="range",
                            replicas=1).close()
        first.cl.rebalance(root, n_shards=2, policy="hash",
                           docs_per_segment=40).close()
    assert _files(roots["mixed"]) == _files(roots["ref"])
    assert sorted(f for f in os.listdir(roots["mixed"])
                  if f.startswith("gen-")) == ["gen-002"]
    qi, qv = _queries([3, 111, 239])
    with PORT.session(roots["mixed"]) as p, REF.session(roots["ref"]) as j:
        _same(p.search_typed(Query(qi, qv)), j.search_typed(JQuery(qi, qv)))
        assert p.store.generation == 2 and p.store.n_shards == 2


# ---------------------------------------------------------------------------
# search: port against reference, and against the union store
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def c4x2(tmp_path_factory):
    """A 4-shard x 2-replica hash cluster and a union store, written by
    the reference."""
    tmp = tmp_path_factory.mktemp("torch-cluster")
    root = str(tmp / "c4x2")
    j_cluster.build_sharded_store(root, DOCS, **BUILD)
    union = str(tmp / "union")
    store = JStore.create(union, vocab_size=CFG.vocab_size,
                          docs_per_segment=64)
    store.append_docs(DOCS)
    store.close()
    return root, union


@pytest.mark.parametrize("jb,tb", PAIRS)
def test_port_cluster_equals_reference_cluster_and_union_store(c4x2, jb, tb):
    root, union = c4x2
    qi, qv = _queries([3, 111, 200, 239])
    with Side(True, tb).session(root) as p, Side(False, jb).session(root) as j:
        got = p.search_typed(Query(qi, qv))
        _same(got, j.search_typed(JQuery(qi, qv)))
        assert _stats(p.last_stats) == _stats(j.last_stats)
        assert p.last_stats.docs_scored == len(DOCS)
        warm = p.search_typed(Query(qi, qv))
        _same(warm, got)
        assert p.last_stats.cache_hits == p.last_stats.segments_scored > 0
        assert p.compile_stats["per_shard"] == [1, 1, 1, 1]
    with FlashSearchSession(FlashStore.open(union), CFG, "cpu", tb) as u, \
            JSession(JStore.open(union), j_smoke(), backend=jb) as ju:
        _same(got, u.search_typed(Query(qi, qv)))
        _same(got, ju.search_typed(JQuery(qi, qv)))


def test_range_cluster_equals_the_reference(tmp_path):
    root = str(tmp_path / "range")
    t_cluster.build_sharded_store(root, corpus=CORPUS, n_shards=3,
                                  policy="range", vocab_size=CFG.vocab_size,
                                  docs_per_segment=32).close()
    qi, qv = _queries([42, 200])
    with PORT.session(root) as p, REF.session(root) as j:
        _same(p.search_typed(Query(qi, qv)), j.search_typed(JQuery(qi, qv)))
        assert _stats(p.last_stats) == _stats(j.last_stats)


def _each(tmp_path, scenario, build_docs, **build):
    """``scenario(side, session)`` on a cluster the reference writes, once
    a package; both observations must be equal. Returns the port's."""
    root = str(tmp_path / "c")
    j_cluster.build_sharded_store(root, build_docs,
                                  vocab_size=CFG.vocab_size, **build)
    out = []
    for side in (REF, PORT):
        with side.session(root) as sess:
            out.append(scenario(side, sess))
    assert out[0] == out[1]
    return out[1]


def _result(res):
    return (res.doc_ids.tolist(), np.asarray(res.scores).view(
        np.uint32).tolist())


def test_all_shards_skipped_returns_the_sentinel(tmp_path):
    def scenario(side, sess):
        r = sess.search_typed(side.query(*_query_rows([[(200, 1)],
                                                       [(300, 2)]])))
        st_ = sess.last_stats
        return _result(r), _stats(st_)

    (ids, scores), stats = _each(tmp_path, scenario, _graded_docs(24),
                                 n_shards=4, docs_per_segment=4)
    assert (np.asarray(ids) == -1).all()
    assert stats["skip_rate"] == 1.0 and stats["docs_scored"] == 0


def test_empty_shards_and_k_above_a_shards_rows(tmp_path):
    """6 graded docs over 4 range shards (none holds k = 4): equal to the
    reference and to the union store, the graded order; 2 docs over 4
    hash shards: the -1 / -inf tail."""
    def scenario(side, sess):
        return _result(sess.search_typed(side.query(
            *_query_rows([[(0, 1)]])))), _stats(sess.last_stats)

    (ids, scores), stats = _each(tmp_path, scenario, _graded_docs(6),
                                 n_shards=4, policy="range",
                                 docs_per_segment=2)
    assert ids == [[0, 1, 2, 3]]
    union = FlashStore.create(str(tmp_path / "u"), vocab_size=CFG.vocab_size,
                              docs_per_segment=2)
    union.append_docs(_graded_docs(6))
    with FlashSearchSession(union, CFG, "cpu", "torch") as u:
        assert _result(u.search_typed(Query(*_query_rows([[(0, 1)]])))) \
            == (ids, scores)
    (ids, scores), _ = _each(tmp_path / "two", scenario, _graded_docs(2),
                             n_shards=4)
    assert ids[0][2:] == [-1, -1]
    assert np.isneginf(np.asarray(scores, np.uint32).view(
        np.float32)[0, 2:]).all()


def test_dup_doc_id_across_shards_keeps_the_higher_score(tmp_path):
    def scenario(side, sess):
        return _result(sess.search_typed(side.query(
            *_query_rows([[(50, 3)]]))))

    root = str(tmp_path / "c")
    j_cluster.build_sharded_store(root, _graded_docs(8), n_shards=2,
                                  policy="range", vocab_size=CFG.vocab_size,
                                  docs_per_segment=4)
    # id 100 in both shards: shard 0's copy scores lower (extra word)
    cl = j_cluster.ShardedStore.open(root)
    cl.store(0, 0).append_docs([(100, [(50, 3), (60, 4)])])
    cl.store(1, 0).append_docs([(100, [(50, 3)])])
    cl.close()
    out = []
    for side in (REF, PORT):
        with side.session(root) as sess:
            out.append(scenario(side, sess))
    assert out[0] == out[1]
    ids, scores = out[1]
    assert ids[0][0] == 100 and ids[0].count(100) == 1
    assert ids[0][1:] == [-1, -1, -1]
    np.testing.assert_allclose(np.uint32(scores[0][0]).view(np.float32), 1.0,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# replica failover
# ---------------------------------------------------------------------------
class _Exploding:
    """Stands in for a session whose backing replica died."""

    def __init__(self, inner):
        self._inner = inner

    def search(self, *a, **k):
        raise OSError("replica storage gone")

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_a_dead_primary_fails_over_with_the_same_result(tmp_path):
    def scenario(side, sess):
        q = side.query(*_queries([1, 99, 150]))
        healthy = _result(sess.search_typed(q))
        router = sess.router
        router._sessions[2][0] = _Exploding(router._session(2, 0))
        failed_over = _result(sess.search_typed(q))
        seen = (router.health(), sess.last_stats.failovers)
        again = _result(sess.search_typed(q))
        router.reset_health()
        return healthy, failed_over, again, seen, router.failovers

    healthy, failed_over, again, (health, failovers), lifetime = _each(
        tmp_path, scenario, DOCS, n_shards=4, replicas=2,
        docs_per_segment=16)
    assert healthy == failed_over == again
    assert health[2] == [False, True] and failovers == 1 and lifetime == 1


def test_all_replicas_down_raises_and_marks_nothing(tmp_path):
    def scenario(side, sess):
        q = side.query(*_query_rows([[(0, 1)]]))
        sess.search_typed(q)
        for r in range(2):
            sess.router._sessions[0][r] = _Exploding(
                sess.router._session(0, r))
        with pytest.raises(side.cl.ClusterSearchError,
                           match="shard 0") as ei:
            sess.search_typed(q)
        return (ei.value.shard, sorted(ei.value.replica_errors),
                sess.router.health(), sess.router.failovers)

    shard, reps, health, failovers = _each(
        tmp_path, scenario, _graded_docs(12), n_shards=2, replicas=2,
        docs_per_segment=4)
    assert shard == 0 and reps == [0, 1]
    assert health == [[True, True], [True, True]] and failovers == 0


def test_a_malformed_query_does_not_poison_health(tmp_path):
    def scenario(side, sess):
        bad_qi = np.full((1, 4), -1, np.int32)      # ids/vals widths differ
        bad_qi[0, 0] = 0
        with pytest.raises(side.cl.ClusterSearchError):
            sess.search(bad_qi, np.ones((1, 3), np.float32))
        health = sess.router.health()
        res = sess.search_typed(side.query(*_query_rows([[(0, 1)]])))
        return health, _result(res)

    health, (ids, _) = _each(tmp_path, scenario, _graded_docs(12),
                             n_shards=2, replicas=2, docs_per_segment=4)
    assert health == [[True, True], [True, True]] and ids[0][0] == 0


def test_vocab_mismatch_is_refused(tmp_path):
    root = str(tmp_path / "c")
    t_cluster.build_sharded_store(root, _graded_docs(4), n_shards=2,
                                  vocab_size=1024).close()
    for side in (REF, PORT):
        with pytest.raises(ValueError, match="vocab_size"):
            side.session(root)


def test_submit_after_close_raises(tmp_path):
    root = str(tmp_path / "c")
    t_cluster.build_sharded_store(root, _graded_docs(4), n_shards=2,
                                  vocab_size=CFG.vocab_size).close()
    sess = PORT.session(root)
    sess.close()
    with pytest.raises(RuntimeError, match="closed"):
        sess.submit(np.array([0], np.int32), np.array([1.0], np.float32))


# ---------------------------------------------------------------------------
# concurrency: 16 clients through submit, every row the serial one
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tb", ["torch", "gpu"])
def test_concurrent_submits_equal_serial_rows(c4x2, tb):
    root, _ = c4x2
    idxs = [7 * i % 240 for i in range(16)]
    with Side(True, tb).session(root) as sess:
        serial = {i: sess.search_typed(Query(*_queries([i]))) for i in idxs}
        sess.service(max_batch=8, max_delay_ms=5.0)
        rows, errs = {}, []

        def client(i):
            try:
                q = j_corpus.make_query(CORPUS, i, CFG.max_query_nnz)
                rows[i] = sess.submit(Query(*q)).result(timeout=120)
            except Exception as e:                # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in idxs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        for i in idxs:
            np.testing.assert_array_equal(rows[i].doc_ids,
                                          serial[i].doc_ids[0])
            np.testing.assert_array_equal(
                rows[i].scores.view(np.uint32),
                serial[i].scores[0].view(np.uint32))
        assert all(c <= 4 for c in sess.compile_stats["per_shard"])


# ---------------------------------------------------------------------------
# live writes through the cluster: routed by the partitioner
# ---------------------------------------------------------------------------
def test_appends_route_to_the_owner_on_every_replica(tmp_path):
    """``enable_ingest``, appends routed by the live partitioner to every
    replica of their owner shard, a flush: the same files and results
    as the reference's same steps."""
    extra = _corpus_docs(j_corpus.synthesize(
        20, CFG.vocab_size, CFG.avg_nnz_per_doc, CFG.nnz_pad, seed=6))
    extra = [(d + 1000, p) for d, p in extra]
    roots = {}
    out = []
    for side in (REF, PORT):
        roots[side.port] = root = str(tmp_path / ("port" if side.port
                                                  else "ref"))
        j_cluster.build_sharded_store(root, DOCS[:120], n_shards=2,
                                      replicas=2, vocab_size=CFG.vocab_size,
                                      docs_per_segment=32)
        with side.session(root) as sess:
            sess.enable_ingest(seal_docs=8, auto_compact=False)
            owners = [sess.append(d, p) for d, p in extra]
            qi, qv = _queries([0, 19], j_corpus.synthesize(
                20, CFG.vocab_size, CFG.avg_nnz_per_doc, CFG.nnz_pad,
                seed=6))
            live = _result(sess.search_typed(side.query(qi, qv)))
            sealed = sess.flush_ingest()
            after = _result(sess.search_typed(side.query(qi, qv)))
            out.append((owners, live, after, sealed,
                        _stats(sess.last_stats)))
    assert out[0] == out[1]
    owners, live, after, _, _ = out[1]
    assert live == after and live[0][0][0] == 1000 and live[0][1][0] == 1019
    np.testing.assert_array_equal(
        owners, j_cluster.HashPartitioner(2).shard_of(
            [d for d, _ in extra]))
    assert _files(roots[True]) == _files(roots[False])
