"""The serving tier and the write path on a mesh, on the CPU: ranks of a
gloo ``torch.distributed`` world, one process each
(``tests/torch_mesh_service_ranks.py``). Rank 0 leads each coalesced
batch and the live snapshot; ranks 1-7 follow
(``repro_torch.distributed.lockstep``).

One module-scoped world of 8 ranks (4 x 2, ``("data", "model")``) runs
every served surface in turn, and a world of 2 with a short group timeout
of its own idles past that timeout and then plants a follower that
raises before it scores. The reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, its sessions and
engine on a 4 x 2 mesh of its own, over stores it writes from the same
numpy documents. The port's single-device session runs here. Counts are
integral, so every comparison is bit for bit (doc ids, and the scores'
bits): no tolerance is used.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_service_ranks as ranks
from repro_torch.configs.paper_search import smoke
from repro_torch.core import corpus as corpus_lib
from repro_torch.core.engine import PatternSearchEngine
from repro_torch.ingest.pipeline import MemCorpusCache, Snapshot
from repro_torch.serve import Query
from repro_torch.storage import FlashSearchSession, FlashStore
from repro_torch.storage.slabcache import SlabCache

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CFG = smoke()
N_DOCS, PER_SEGMENT, SEED = 240, 48, 21     # five segments, five slabs
QUERY_DOCS = tuple(range(0, N_DOCS, 15))    # 16 self-queries
LIVE_NEW = (3, 25)                          # appended docs queried live
REF_BACKENDS = {"torch": "jnp", "gpu": "pallas", "gpu_packed": "pallas_packed"}

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
from repro.configs.paper_search import smoke
from repro.core.corpus import Corpus
from repro.core.engine import PatternSearchEngine
from repro.distributed.meshctx import MeshCtx
from repro.serve.api import Query
from repro.storage import FlashSearchSession, FlashStore
from repro.storage.store import _corpus_docs

assert len(jax.devices()) == 8
inp = np.load(sys.argv[1])
root = sys.argv[3]
cfg = smoke()
# an Auto-axis mesh (ROADMAP C25)
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(4, 2),
                         ("data", "model"))
ctx = MeshCtx(mesh=mesh, dp_axes=("data",), fsdp_axis="data",
              tp_axis="model")
corpus = Corpus(inp["doc_ids"], inp["ids"], inp["vals"], inp["norms"])
new = Corpus(inp["new_doc_ids"], inp["new_ids"], inp["new_vals"],
             inp["new_norms"])
new_docs = _corpus_docs(new)
q = Query(inp["qi"], inp["qv"])
live_q = Query(inp["live_qi"], inp["live_qv"])
out = {}

def store(name):
    s = FlashStore.create(os.path.join(root, name),
                          vocab_size=cfg.vocab_size,
                          docs_per_segment=int(inp["per_segment"]))
    s.append_docs(_corpus_docs(corpus))
    return s

ro = store("ro")
for b in ("jnp", "pallas", "pallas_packed"):
    sess = FlashSearchSession(ro, cfg, ctx, backend=b)
    r = sess.search_typed(q)
    out[f"ro_{b}_ids"], out[f"ro_{b}_scores"] = r.doc_ids, r.scores
r = PatternSearchEngine(corpus, cfg, ctx, backend="pallas").search_typed(q)
out["engine_ids"], out["engine_scores"] = r.doc_ids, r.scores

sess = FlashSearchSession(store("live"), cfg, ctx, backend="pallas")
sess.enable_ingest(seal_docs=int(inp["seal_docs"]), auto_compact=False)
spans = inp["live_appends"]
for step, (a, b) in enumerate(spans):
    for d, p in new_docs[a:b]:
        sess.append(d, p)
    r = sess.search_typed(live_q)
    out[f"live{step}_ids"], out[f"live{step}_scores"] = r.doc_ids, r.scores
    if step == 0:
        sess.flush_ingest()
sess.ingest.compact_once()
r = sess.search_typed(live_q)
out["live2_ids"], out["live2_scores"] = r.doc_ids, r.scores
sess.close()
np.savez(sys.argv[2], **out)
"""


def _docs(corpus):
    """ELL rows -> [(doc_id, [(word, count), ...])]."""
    docs = []
    for r in range(corpus.n_docs):
        keep = corpus.ids[r] >= 0
        docs.append((int(corpus.doc_ids[r]),
                     list(zip(corpus.ids[r][keep].tolist(),
                              corpus.vals[r][keep].astype(int).tolist()))))
    return docs


def _corpora():
    base = corpus_lib.synthesize(N_DOCS, CFG.vocab_size, CFG.avg_nnz_per_doc,
                                 CFG.nnz_pad, seed=SEED)
    new = corpus_lib.synthesize(ranks.COMPACT_APPENDS, CFG.vocab_size,
                                CFG.avg_nnz_per_doc, CFG.nnz_pad,
                                seed=SEED + 1)
    new.doc_ids[:] += N_DOCS
    return base, new


def _queries(corpus, idxs):
    return [corpus_lib.make_query(corpus, i, CFG.max_query_nnz)
            for i in idxs]


def _stacked(queries):
    return np.stack([q[0] for q in queries]), np.stack([q[1] for q in queries])


def _write_store(root, corpus):
    store = FlashStore.create(str(root), vocab_size=CFG.vocab_size,
                              docs_per_segment=PER_SEGMENT)
    store.append_docs(_docs(corpus))
    store.close()
    return str(root)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_service")
    base, new = _corpora()
    queries = _queries(base, QUERY_DOCS)
    live = [queries[0], queries[7]] + _queries(new, LIVE_NEW)
    roots = {name: _write_store(d / name, base)
             for name in ("ro", "live", "compact", "single_live")}
    return {"dir": d, "base": base, "new": new, "queries": queries,
            "live": live, "roots": roots, "new_docs": _docs(new)}


@pytest.fixture(scope="module")
def world(inputs):
    roots = {k: v for k, v in inputs["roots"].items() if k != "single_live"}
    base = inputs["base"]
    return ranks.run(8, "serve", inputs["dir"] / "world", roots=roots,
                     queries=inputs["queries"],
                     corpus=(base.doc_ids, base.ids, base.vals, base.norms),
                     new_docs=inputs["new_docs"],
                     live_queries=inputs["live"])


@pytest.fixture(scope="module")
def short(inputs):
    return ranks.run(2, "short", inputs["dir"] / "short",
                     timeout_s=ranks.SHORT_TIMEOUT_S,
                     store_root=inputs["roots"]["ro"],
                     queries=inputs["queries"])


@pytest.fixture(scope="module")
def reference(inputs):
    """The JAX package's sessions and engine on its own 4 x 2 mesh."""
    d = inputs["dir"] / "reference"
    d.mkdir()
    base, new = inputs["base"], inputs["new"]
    inp = {"per_segment": PER_SEGMENT, "seal_docs": ranks.SEAL_DOCS,
           "live_appends": np.array(ranks.LIVE_APPENDS)}
    for name, c in (("", base), ("new_", new)):
        for field in ("doc_ids", "ids", "vals", "norms"):
            inp[name + field] = getattr(c, field)
    inp["qi"], inp["qv"] = _stacked(inputs["queries"])
    inp["live_qi"], inp["live_qv"] = _stacked(inputs["live"])
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, str(d / "in.npz"),
         str(d / "out.npz"), str(d)], env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-device sessions: the read-only store on each
    backend, and the write path's op sequence on a store of its own."""
    out = {}
    qi, qv = _stacked(inputs["queries"])
    for backend in ranks.BACKENDS:
        sess = FlashSearchSession(FlashStore.open(inputs["roots"]["ro"]), CFG,
                                  "cpu", backend)
        out["ro", backend] = sess.search_typed(Query(qi, qv))
        sess.close()
    sess = FlashSearchSession(FlashStore.open(inputs["roots"]["single_live"]),
                              CFG, "cpu", "gpu")
    sess.enable_ingest(seal_docs=ranks.SEAL_DOCS, auto_compact=False)
    live = Query(*_stacked(inputs["live"]))
    for step, (a, b) in enumerate(ranks.LIVE_APPENDS):
        for d, p in inputs["new_docs"][a:b]:
            sess.append(d, p)
        out["live", step] = sess.search_typed(live)
        if step == 0:
            sess.flush_ingest()
    sess.ingest.compact_once()
    out["live", 2] = sess.search_typed(live)
    out["ingest_stats"] = sess.ingest.stats
    sess.close()
    # the approximate tier after an exact query, with and without a cache
    for case, cached in (("leader_warm", True), ("leader_cold", False)):
        store = FlashStore.open(inputs["roots"]["ro"])
        cache = SlabCache() if cached else None
        exact, approx = (
            FlashSearchSession(store, CFG, "cpu", "gpu", slab_cache=cache,
                               cache_bytes=0, **kw)
            for kw in ({}, dict(mode="auto", approx_min_docs=1,
                                candidates=ranks.APPROX_CANDIDATES)))
        one = [Query(*_stacked([inputs["queries"][q]]))
               for q in ranks.APPROX_QUERIES]
        exact.search_typed(one[0])
        out["approx", case] = [_rows(approx.search_typed(q))[0] for q in one]
        exact.close()
        approx.close()
    return out


def _same(got, want, label=""):
    (gi, gs), (wi, ws) = got, want
    np.testing.assert_array_equal(gi, wi, label)
    np.testing.assert_array_equal(np.asarray(gs, np.float32).view(np.uint32),
                                  np.asarray(ws, np.float32).view(np.uint32),
                                  label)


def _rows(res):
    """A batched result's rows, as the service returns them."""
    return [(res.doc_ids[l], res.scores[l]) for l in range(len(res.doc_ids))]


def _ref_rows(reference, key):
    return [(i, s) for i, s in zip(reference[key + "_ids"],
                                   reference[key + "_scores"])]


def _leader(world):
    assert world[0]["role"] == "leader"
    assert all(o["role"] == "follower" for o in world[1:])
    return world[0]


@pytest.mark.parametrize("backend", ranks.BACKENDS)
def test_served_rows_equal_the_reference_mesh_and_one_device(
        world, reference, single, backend):
    got = _leader(world)["ro", backend]
    want = _ref_rows(reference, f"ro_{REF_BACKENDS[backend]}")
    for i, (g, w, s) in enumerate(zip(got, want, _rows(single["ro",
                                                              backend]))):
        _same(g, w, f"reference, query {i}")
        _same(g, s, f"one device, query {i}")
    assert [int(g[0][0]) for g in got] == list(QUERY_DOCS)


@pytest.mark.parametrize("backend", ranks.BACKENDS)
def test_every_follower_scored_the_leaders_batches(world, backend):
    lead = _leader(world)
    n = lead["batches", backend]
    assert 4 <= n <= len(QUERY_DOCS)
    assert lead["lockstep", backend]["batches"] == n
    for rank, out in enumerate(world[1:], 1):
        st = out["lockstep", backend]
        assert st["batches"] == n and st["failed"] == 0, f"rank {rank}"
        # the leader's counts were read before its stop went out
        assert st["records"] == lead["lockstep", backend]["records"] + 1


def test_service_options_and_a_failed_batch_on_a_mesh(world, single):
    lead = _leader(world)
    assert lead["deadline"] == "submit"
    assert lead["shed"] == "quota"
    full = _rows(single["ro", "gpu"])
    _same(lead["k2"], (full[1][0][:2], full[1][1][:2]), "k = 2")
    _same(lead["after_shed"], full[2], "the batch after the shed")
    # a batch that raised on every rank before scoring, one that raised
    # on rank 0 after scoring and one on rank 3 after scoring: each fails
    # on every rank, and the next batch is bit for bit
    assert lead["poisoned"] == [
        ("ValueError", "a poisoned batch")] * 2 + [
        ("BatchFailed", "a follower rank failed this batch")]
    _same(lead["after_poison"], full[4], "the batch after the failed ones")
    # the expired and the shed request formed no batch: six batches went
    # out, every follower scored them, and the three poisoned ones failed
    # on every rank
    assert [(o["opts"]["batches"], o["opts"]["failed"])
            for o in world] == [(6, 3)] * 8


def test_resident_engine_behind_a_service_on_a_mesh(world, reference,
                                                    inputs):
    lead = _leader(world)
    want = _ref_rows(reference, "engine")
    plain = PatternSearchEngine(inputs["base"], CFG, "cpu", "gpu")
    one = _rows(plain.search_typed(Query(*_stacked(inputs["queries"]))))
    for i, (g, w, s) in enumerate(zip(lead["engine"], want, one)):
        _same(g, w, f"reference, query {i}")
        _same(g, s, f"one device, query {i}")
    assert all(o["engine_batches"] == lead["engine_batches"] for o in world)
    for out in world[1:]:
        assert "only rank 0 of a mesh serves" in out["engine_service"]


@pytest.mark.parametrize("step", [0, 1, 2])
def test_write_path_equals_the_reference_mesh_and_one_device(
        world, reference, single, step):
    """append 20, search; flush, append 10, search; compact_once, search:
    the memtable, sealed deltas and a fold, all through rank 0."""
    got = _leader(world)["live", step]
    want = _ref_rows(reference, f"live{step}")
    for i, (g, w, s) in enumerate(zip(got, want,
                                      _rows(single["live", step]))):
        _same(g, w, f"reference, query {i}")
        _same(g, s, f"one device, query {i}")
    new_ids = [N_DOCS + j for j in LIVE_NEW]
    present = [new_ids[0]] if step == 0 else new_ids
    assert [int(g[0][0]) for g in got[2:]][:len(present)] == present


def test_only_the_leader_holds_the_write_path(world, single, inputs):
    lead = _leader(world)
    assert lead["ingest_stats"] == dataclasses.asdict(single["ingest_stats"])
    assert lead["ingest_stats"]["seals"] == 4
    assert lead["ingest_stats"]["compactions"] == 1
    for rank, out in enumerate(world[1:], 1):
        assert out["follower_ingest"] is None
        for name in ("enable_ingest", "append", "flush_ingest"):
            assert "only rank 0 holds the write path" in out[
                "refused", name], f"rank {rank} {name}"
        for name in ("service", "submit"):
            assert "only rank 0 of a mesh serves" in out["refused", name]
        assert out["live_batches"] == lead["live_batches"]
    # one WAL, rank 0's: its bytes are the single-device run's
    wal = [Path(inputs["roots"][k]) / "wal.log" for k in ("live",
                                                          "single_live")]
    assert wal[0].read_bytes() == wal[1].read_bytes()


def test_compaction_under_a_live_service(world, inputs):
    """The compactor folds while batches run: no rank fails a batch (a
    follower that opened a folded file too late would raise
    FileNotFoundError), and the last search equals one device's over the
    final store."""
    lead = _leader(world)
    assert lead["compact_stats"]["compactions"] >= 2
    assert lead["compact_stats"]["seals"] >= (ranks.COMPACT_APPENDS
                                              // ranks.SEAL_DOCS)
    n = lead["compact_lockstep"]["batches"]
    for out in world:
        st = out["compact_lockstep"]
        assert st["batches"] == n and st["failed"] == 0
    sess = FlashSearchSession(FlashStore.open(inputs["roots"]["compact"]),
                              CFG, "cpu", "gpu")
    want = _rows(sess.search_typed(Query(*_stacked(inputs["live"]))))
    sess.close()
    for i, (g, w) in enumerate(zip(lead["compact_last"], want)):
        _same(g, w, f"query {i}")


def test_memo_hits_agree_on_every_rank(world, single):
    lead = _leader(world)
    _same(lead["memo_rows"][0], lead["memo_rows"][1])
    _same(lead["memo_rows"][1], _rows(single["ro", "gpu"])[3])
    # the leader's verdict went out with the record: ranks 0-3 count one
    # miss then one hit in their own memos, ranks 4-7 keep none, and
    # every rank reports the second batch as a memo hit
    assert [o["memo"] for o in world] == [((1, 1), 1)] * 4 + [(None, 1)] * 4


@pytest.mark.parametrize("case", list(ranks.APPROX_CACHES))
def test_the_approximate_tier_takes_the_leaders_cache_verdict(
        world, single, case):
    """An exact service warms the slab caches of some ranks, then an auto
    service (approx past one doc) serves the warm query and another. The
    tier scores a segment the leader's cache holds whole and any other
    its candidate pool, on every rank: rank 0's rows are one device's
    with the leader's cache, whatever the followers' caches hold."""
    got = _leader(world)["approx", case]
    for i, (g, w) in enumerate(zip(got, single["approx", case])):
        _same(g, w, f"query {i}")
    # the verdict decided the tier: with the leader's cache warm the
    # warm query's every segment scored whole, so it is the exact row;
    # with it cold the candidate pools gave another row
    exact = _rows(single["ro", "gpu"])[ranks.APPROX_QUERIES[0]]
    if case == "leader_warm":
        _same(got[0], exact, "the warm query")
    else:
        assert not np.array_equal(got[0][0], exact[0])


def test_a_waiting_follower_outlives_the_group_timeout(short, single):
    """The leader sleeps 1.5 group timeouts before its first batch; the
    follower waits for it on the lockstep's own group, whose timeout is
    ``RECORD_TIMEOUT``."""
    lead, follower = short
    _same(lead["after_idle"], _rows(single["ro", "torch"])[0])
    st = follower["idle"]
    assert (st["records"], st["batches"], st["failed"]) == (2, 1, 0)


def test_a_follower_that_fails_before_scoring_breaks_the_lockstep(short):
    """The planted follower raises before it scores and goes to the
    end-of-batch reduction while the leader's batch waits in the
    engine's: both ranks raise at the group timeout, the follower's loop
    ends, and the leader refuses every later batch at once."""
    lead, follower = short
    assert lead["diverged"] is not None
    for name in ("after", "later"):
        kind, msg = lead[name]
        assert kind == "RuntimeError" and "the lockstep broke" in msg
    assert lead["diverged_stats"]["records"] == 1
    assert follower["diverged"] is not None


def test_a_followers_snapshot_reads_the_files_the_leader_keeps(tmp_path):
    """A follower's snapshot, rebuilt from the leader's spec after a fold
    committed, opens the folded files from the graveyard the leader's
    registered snapshot keeps, and builds the memtable's ELL bit for bit;
    once the leader's snapshot closes, the graveyard drains."""
    base, new = _corpora()
    root = _write_store(tmp_path / "store", base)
    lead = FlashSearchSession(FlashStore.open(root), CFG, "cpu", "gpu")
    pipe = lead.enable_ingest(seal_docs=ranks.SEAL_DOCS, auto_compact=False)
    new_docs = _docs(new)
    for d, p in new_docs[:36]:
        lead.append(d, p)                  # 4 deltas, 4 in the memtable
    snap = pipe.capture()
    spec = pickle.loads(pickle.dumps(snap.spec))
    assert pipe.compact_once() == 4
    follower = Snapshot.from_spec(spec, FlashStore.open(root),
                                  MemCorpusCache())
    deltas = [e.name for e in follower.entries[-4:]]
    assert [e.name for e in follower.entries] == [e.name
                                                  for e in snap.entries]
    assert not set(deltas) & {e.name for e in lead.store.entries}
    for name in deltas:                    # folded, parked, still readable
        assert follower.segment(name).n_docs == ranks.SEAL_DOCS
        follower.release(name)
    got, trunc = follower.memtable_corpus(CFG.nnz_pad)
    want, want_trunc = snap.memtable_corpus(CFG.nnz_pad)
    assert got.n_docs == 4 and trunc == want_trunc
    for field in ("doc_ids", "ids", "vals", "norms"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert (follower.memo_state, follower.generation) == (
        snap.memo_state, snap.generation)
    follower.close()
    snap.close()
    assert not any((Path(root) / name).exists() for name in deltas)
    lead.close()
