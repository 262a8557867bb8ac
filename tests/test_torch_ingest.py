"""The port's ingest tier (WAL, memtable, IngestPipeline, the live
FlashSearchSession) against the JAX package's, on the CPU.

Every scenario runs once in each package on the same documents, each in
its own directory, and the two runs must agree: the WAL bytes, every
segment file and the manifest, ``IngestStats``, ``SearchStats``, and the
search results (doc ids, and the scores' bits: integral counts make them
exact). Session scenarios run over the four backend pairs (jnp/torch,
pallas/gpu, pallas_packed/gpu_packed, pallas_fused/gpu_fused; the
reference's Pallas kernels in interpret mode). Also each package opens
and replays the other's store and WAL. The scenarios are those of
tests/test_ingest.py for one store; the property test compares port and
reference on the same op sequence, never a live store with a fresh one,
because results depend on segment layout (ROADMAP C1)."""
import dataclasses
import hashlib
import os
import shutil
import tempfile
import threading

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro import ingest as j_ingest
from repro.configs.paper_search import smoke as j_smoke
from repro.core import corpus as j_corpus
from repro.serve.api import Query as JQuery
from repro.storage import FlashSearchSession as JSession
from repro.storage import FlashStore as JStore
from repro.storage.store import _corpus_docs
from repro_torch import ingest as t_ingest
from repro_torch.configs.paper_search import smoke
from repro_torch.serve import Query
from repro_torch.storage import FlashSearchSession, FlashStore

torch.set_num_threads(2)
PAIRS = [("jnp", "torch"), ("pallas", "gpu"),
         ("pallas_packed", "gpu_packed"), ("pallas_fused", "gpu_fused")]
CFG = smoke()


@dataclasses.dataclass(frozen=True)
class Side:
    """One package's ingest surface: the reference's or the port's."""
    port: bool
    backend: str = ""

    @property
    def ing(self):
        return t_ingest if self.port else j_ingest

    @property
    def Store(self):
        return FlashStore if self.port else JStore

    def session(self, store, **kw):
        if self.port:
            return FlashSearchSession(store, CFG, "cpu",
                                      self.backend or "torch", **kw)
        return JSession(store, j_smoke(), backend=self.backend or "jnp", **kw)

    def search(self, sess, qi, qv):
        return sess.search_typed((Query if self.port else JQuery)(qi, qv))


REF, PORT = Side(False), Side(True)


def _sides(jb, tb):
    return Side(False, jb), Side(True, tb)


def _docs(n, vocab=500, seed=0, start_id=0):
    rng = np.random.default_rng(seed)
    return [(start_id + i,
             sorted((int(w), int(rng.integers(1, 20))) for w in
                    rng.choice(vocab, int(rng.integers(1, 12)),
                               replace=False)))
            for i in range(n)]


def _synth_docs(n, seed):
    c = j_corpus.synthesize(n, CFG.vocab_size, CFG.avg_nnz_per_doc,
                            CFG.nnz_pad, seed=seed)
    return c, _corpus_docs(c)


def _query(pairs):
    qi = np.full((1, CFG.max_query_nnz), -1, np.int32)
    qv = np.zeros((1, CFG.max_query_nnz), np.float32)
    for j, (w, c) in enumerate(pairs[:CFG.max_query_nnz]):
        qi[0, j] = w
        qv[0, j] = c
    return qi, qv


def _same(got, want, label=""):
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids, label)
    np.testing.assert_array_equal(np.asarray(got.scores).view(np.uint32),
                                  np.asarray(want.scores).view(np.uint32),
                                  label)


def _files(root):
    """sha256 of every file of a store directory but the lock-free tmp
    files: segments, MANIFEST.json and wal.log."""
    return {f: hashlib.sha256(open(os.path.join(root, f), "rb").read()
                              ).hexdigest()
            for f in sorted(os.listdir(root)) if not f.endswith(".tmp")}


def _both(tmp_path, scenario, sides=(REF, PORT), files=True):
    """Run ``scenario(side, root)`` in each package, each in its own
    directory, and return both observations; with ``files`` the two
    directories must hold the same bytes."""
    out = []
    for side in sides:
        root = str(tmp_path / ("port" if side.port else "ref"))
        obs = scenario(side, root)
        out.append((obs, _files(root)))
    (ref, ref_files), (port, port_files) = out
    if files:
        assert port_files == ref_files
    return ref, port


def _assert_equal_obs(ref, port):
    assert ref.keys() == port.keys()
    for k in ref:
        if hasattr(ref[k], "doc_ids"):
            _same(port[k], ref[k], k)
        else:
            assert port[k] == ref[k], k


# ---------------------------------------------------------------------------
# WriteAheadLog: the same bytes, the same repairs
# ---------------------------------------------------------------------------
WAL_DOCS = {
    "small": _docs(5),
    # word ids up to the 19-bit key, a count above the 12-bit field
    # (saturates on disk) and a document with no words
    "edges": [(0, [(0, 1), ((1 << 19) - 1, 4095)]), (7, []),
              ((1 << 31) - 1, [(3, 5000), (9, 1)])],
}


@pytest.mark.parametrize("case", sorted(WAL_DOCS))
def test_wal_bytes_are_the_reference_bytes(tmp_path, case):
    docs = WAL_DOCS[case]
    paths = {}
    for side in (REF, PORT):
        paths[side.port] = str(tmp_path / f"{side.port}.log")
        with side.ing.WriteAheadLog(paths[side.port]) as wal:
            assert [wal.append(d) for d in docs] == list(
                range(1, len(docs) + 1))
    raw = open(paths[False], "rb").read()
    assert open(paths[True], "rb").read() == raw
    assert raw.startswith(t_ingest.wal.MAGIC)
    # each package replays the other's log to the same records
    with j_ingest.WriteAheadLog(paths[True]) as a, \
            t_ingest.WriteAheadLog(paths[False]) as b:
        assert a.records() == b.records() and a.last_seq == b.last_seq
        assert len(b.records()) == len(docs)


def _damage(path, kind):
    if kind == "torn_tail":
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size - 3)
    elif kind == "corrupt_body":
        with open(path, "r+b") as f:
            f.seek(-5, os.SEEK_END)
            b = f.read(1)
            f.seek(-5, os.SEEK_END)
            f.write(bytes([b[0] ^ 0xFF]))
    elif kind == "torn_header":
        with open(path, "wb") as f:
            f.write(b"RSP")
    elif kind == "foreign":
        with open(path, "wb") as f:
            f.write(b"NOTAWAL!" + b"x" * 32)


@pytest.mark.parametrize("kind", ["torn_tail", "corrupt_body", "torn_header",
                                  "foreign"])
def test_wal_repairs_match_the_reference(tmp_path, kind):
    """A torn tail or a corrupt record is cut back to the last intact
    record, a torn header is rewritten empty, a foreign file is refused:
    the same records, repair counts and bytes in both packages, and
    both accept the next append alike."""
    docs = _docs(4)

    def scenario(side, root):
        os.makedirs(root)
        path = os.path.join(root, "wal.log")
        with side.ing.WriteAheadLog(path) as wal:
            for d in docs:
                wal.append(d)
        _damage(path, kind)
        if kind == "foreign":
            with pytest.raises(ValueError, match="magic"):
                side.ing.WriteAheadLog(path)
            return {"refused": True}
        with side.ing.WriteAheadLog(path) as wal:
            got = {"records": wal.records(), "repairs": wal.repairs,
                   "last_seq": wal.last_seq}
            got["next_seq"] = wal.append(_docs(1, start_id=99)[0])
        with side.ing.WriteAheadLog(path) as wal:
            got["reopened"] = wal.records()
        return got

    ref, port = _both(tmp_path, scenario)
    assert port == ref
    if kind in ("torn_tail", "corrupt_body"):
        assert [d for _, d in port["records"]] == docs[:3]
        assert port["repairs"] == 1
    elif kind == "torn_header":
        assert port["records"] == [] and port["repairs"] == 1


def test_wal_reset_discards_and_seq_survives(tmp_path):
    def scenario(side, root):
        os.makedirs(root)
        with side.ing.WriteAheadLog(os.path.join(root, "wal.log")) as wal:
            for d in _docs(3):
                wal.append(d)
            wal.reset()
            n = wal.n_records
            return {"after_reset": n,
                    "seq": wal.append(_docs(1, start_id=99)[0])}

    ref, port = _both(tmp_path, scenario)
    assert port == ref == {"after_reset": 0, "seq": 4}


# ---------------------------------------------------------------------------
# pipeline mechanics: seal, recovery windows, compaction
# ---------------------------------------------------------------------------
def _pipe(side, store, **knobs):
    return side.ing.IngestPipeline(store, side.ing.IngestConfig(**knobs))


def test_seal_threshold_creates_delta_segments_and_resets_wal(tmp_path):
    def scenario(side, root):
        store = side.Store.create(root, vocab_size=512, docs_per_segment=32)
        pipe = _pipe(side, store, seal_docs=4, auto_compact=False)
        for d, p in _docs(10):
            pipe.append(d, p)
        got = {"segments": store.n_segments, "docs": store.n_docs,
               "memtable": len(pipe.memtable), "wal": pipe.wal.n_records,
               "ingest_seq": store.manifest["ingest_seq"]}
        got["flushed"] = pipe.seal()
        got.update(docs_after=store.n_docs, wal_after=pipe.wal.n_records,
                   stats=dataclasses.asdict(pipe.stats),
                   manifest=store.manifest)
        pipe.close()
        return got

    ref, port = _both(tmp_path, scenario)
    assert port == ref
    assert (port["segments"], port["docs"], port["memtable"], port["wal"],
            port["ingest_seq"], port["flushed"]) == (2, 8, 2, 2, 8, 2)
    assert port["docs_after"] == 10 and port["wal_after"] == 0


def test_reopen_replays_only_unsealed_records(tmp_path):
    """Crash between manifest swap and WAL reset: replay skips records
    at or below the manifest's ingest_seq, in both packages."""
    docs = _docs(6)

    def scenario(side, root):
        store = side.Store.create(root, vocab_size=512, docs_per_segment=32)
        pipe = _pipe(side, store, seal_docs=4, auto_compact=False)
        for d, p in docs:
            pipe.append(d, p)
        pipe.wal.close()
        os.unlink(os.path.join(root, side.ing.WAL_NAME))
        with side.ing.WriteAheadLog(os.path.join(root,
                                                 side.ing.WAL_NAME)) as wal:
            for d in docs:
                wal.append(d)
        pipe2 = _pipe(side, side.Store.open(root), seal_docs=100,
                      auto_compact=False)
        got = {"replayed": pipe2.stats.replayed,
               "memtable": pipe2.memtable.docs()}
        pipe2.close()
        return got

    ref, port = _both(tmp_path, scenario)
    assert port == ref
    assert port["replayed"] == 2 and port["memtable"] == docs[4:]


def test_reopen_after_clean_seal_starts_sequence_above_watermark(tmp_path):
    def scenario(side, root):
        store = side.Store.create(root, vocab_size=512, docs_per_segment=32)
        pipe = _pipe(side, store, seal_docs=2, auto_compact=False)
        for d, p in _docs(4):
            pipe.append(d, p)
        pipe.close()
        pipe2 = _pipe(side, side.Store.open(root), seal_docs=100,
                      auto_compact=False)
        seq = pipe2.append(*_docs(1, start_id=50)[0])
        pipe2.close()
        pipe3 = _pipe(side, side.Store.open(root), seal_docs=100,
                      auto_compact=False)
        got = {"seq": seq, "replayed": pipe3.stats.replayed}
        pipe3.close()
        return got

    ref, port = _both(tmp_path, scenario)
    assert port == ref == {"seq": 5, "replayed": 1}


def test_crash_before_manifest_leaves_orphan_and_wal_recovers(tmp_path):
    docs = _docs(5)

    def scenario(side, root):
        store = side.Store.create(root, vocab_size=512, docs_per_segment=32)
        pipe = _pipe(side, store, seal_docs=100, auto_compact=False)
        for d, p in docs:
            pipe.append(d, p)
        orig = store._write_manifest

        def boom(durable=False, manifest=None):
            raise OSError("simulated crash at the commit point")

        store._write_manifest = boom
        with pytest.raises(OSError):
            pipe.seal()
        store._write_manifest = orig
        pipe.wal.close()
        got = {"orphans": sorted(f for f in os.listdir(root)
                                 if f.endswith(".rsps")),
               "segments": store.n_segments, "memtable": len(pipe.memtable)}
        store2 = side.Store.open(root)
        pipe2 = _pipe(side, store2, seal_docs=100, auto_compact=False)
        got["replayed"] = pipe2.memtable.docs()
        store2.compact()
        got["after_gc"] = sorted(f for f in os.listdir(root)
                                 if f.endswith(".rsps"))
        pipe2.close()
        return got

    ref, port = _both(tmp_path, scenario)
    assert port == ref
    assert port["orphans"] and port["segments"] == 0
    assert port["memtable"] == 5 and port["replayed"] == docs
    assert port["after_gc"] == []


def test_append_after_close_raises(tmp_path):
    def scenario(side, root):
        store = side.Store.create(root, vocab_size=512, docs_per_segment=32)
        pipe = _pipe(side, store, auto_compact=False)
        pipe.append(*_docs(1)[0])
        pipe.close()
        with pytest.raises(RuntimeError, match="closed"):
            pipe.append(*_docs(1, start_id=9)[0])
        pipe.close()
        return {"stats": dataclasses.asdict(pipe.stats)}

    ref, port = _both(tmp_path, scenario)
    assert port == ref


def test_capture_is_lazy_and_memtable_build_is_cached(tmp_path):
    def scenario(side, root):
        store = side.Store.create(root, vocab_size=512, docs_per_segment=4)
        store.append_docs(_docs(8))
        pipe = _pipe(side, store, seal_docs=100, auto_compact=False)
        for d, p in _docs(3, start_id=50):
            pipe.append(d, p)
        snap = pipe.capture()
        got = {"entries": len(snap.entries), "fds": len(snap._segments)}
        c1, _ = snap.memtable_corpus(16)
        snap2 = pipe.capture()
        c2, _ = snap2.memtable_corpus(16)
        got["cached"] = c2 is c1
        snap.close()
        snap2.close()
        pipe.append(*_docs(1, start_id=99)[0])
        snap3 = pipe.capture()
        c3, trunc = snap3.memtable_corpus(16)
        got.update(rebuilt=c3 is not c1, n_docs=c3.n_docs, trunc=trunc,
                   ell=[np.asarray(a).tolist() for a in
                        (c3.doc_ids, c3.ids, c3.vals, c3.norms)])
        snap3.close()
        pipe.close()
        return got

    ref, port = _both(tmp_path, scenario)
    assert port == ref
    assert (port["entries"], port["fds"], port["cached"], port["rebuilt"],
            port["n_docs"]) == (2, 0, True, True, 4)


def test_compactor_folds_tail_run_only(tmp_path):
    def scenario(side, root):
        store = side.Store.create(root, vocab_size=512, docs_per_segment=8)
        store.append_docs(_docs(16))
        base = [e.name for e in store.entries]
        pipe = _pipe(side, store, seal_docs=2, fold_min_segments=3,
                     auto_compact=False)
        for d, p in _docs(6, start_id=100):
            pipe.append(d, p)
        got = {"before": store.n_segments, "folded": pipe.compact_once(),
               "base_kept": [e.name for e in store.entries][:2] == base,
               "after": store.n_segments, "docs": store.n_docs,
               "again": pipe.compact_once(),
               "on_disk": sorted(f for f in os.listdir(root)
                                 if f.endswith(".rsps")),
               "entries": sorted(e.name for e in store.entries),
               "stats": dataclasses.asdict(pipe.stats),
               "manifest": store.manifest}
        pipe.close()
        return got

    ref, port = _both(tmp_path, scenario)
    assert port == ref
    assert (port["before"], port["folded"], port["base_kept"],
            port["after"], port["docs"], port["again"]) == \
        (5, 3, True, 3, 22, 0)
    assert port["on_disk"] == port["entries"]


# ---------------------------------------------------------------------------
# the live session, over the four backend pairs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("jb,tb", PAIRS)
def test_snapshot_survives_compaction_gc(tmp_path, jb, tb):
    """A snapshot captured before a fold still scores the old files (the
    graveyard), and the files go when the last snapshot closes."""
    corpus, docs = _synth_docs(60, seed=3)
    qi, qv = j_corpus.make_query(corpus, 33, CFG.max_query_nnz)

    def scenario(side, root):
        store = side.Store.create(root, vocab_size=CFG.vocab_size,
                                  docs_per_segment=16)
        sess = side.session(store)
        pipe = sess.enable_ingest(seal_docs=8, fold_min_segments=2,
                                  auto_compact=False)
        for d, p in docs:
            sess.append(d, p)
        snap = pipe.capture()
        old = [e.name for e in snap.entries]
        got = {"folded": pipe.compact_once()}
        replaced = sorted(set(old) - {e.name for e in store.entries})
        got["parked"] = all(os.path.exists(os.path.join(root, n))
                            for n in replaced)
        got["snap"] = sess._search_view(snap, snap, qi[None], qv[None])
        got["snap_stats"] = dataclasses.asdict(sess.last_stats)
        got["live"] = side.search(sess, qi[None], qv[None])
        got["live_stats"] = dataclasses.asdict(sess.last_stats)
        snap.close()
        got["gone"] = not any(os.path.exists(os.path.join(root, n))
                              for n in replaced) and bool(replaced)
        got["ingest"] = dataclasses.asdict(pipe.stats)
        sess.close()
        return got

    ref, port = _both(tmp_path, scenario, _sides(jb, tb))
    _assert_equal_obs(ref, port)
    assert port["folded"] > 0 and port["parked"] and port["gone"]
    _same(port["snap"], port["live"])
    assert int(port["live"].doc_ids[0, 0]) == 33


@pytest.mark.parametrize("jb,tb", PAIRS)
def test_growing_memtable_launches_log_many_shapes(tmp_path, jb, tb):
    """A memtable that outgrows the largest segment pads to doublings of
    the slab shape: interleaved append/search uses O(log) launch shapes
    in the port, as it compiles O(log) programs in the reference."""
    docs = _docs(40, vocab=CFG.vocab_size, start_id=100)
    qi, qv = _query([(1, 1)])

    def scenario(side, root):
        store = side.Store.create(root, vocab_size=CFG.vocab_size,
                                  docs_per_segment=8)
        store.append_docs(_docs(8, vocab=CFG.vocab_size))
        with side.session(store) as sess:
            sess.enable_ingest(seal_docs=512, auto_compact=False)
            got = {}
            for i, (d, p) in enumerate(docs):
                sess.append(d, p)
                if i % 8 == 7:
                    got[f"search{i}"] = side.search(sess, qi, qv)
                    got[f"stats{i}"] = dataclasses.asdict(sess.last_stats)
                else:
                    side.search(sess, qi, qv)
            got["traces"] = sess.engine.compile_stats["n_traces"]
        return got

    ref, port = _both(tmp_path, scenario, _sides(jb, tb))
    traces = port.pop("traces")
    assert traces <= 4 and ref.pop("traces") <= 4
    _assert_equal_obs(ref, port)


def test_append_requires_enable_ingest_and_validates_vocab(tmp_path):
    def scenario(side, root):
        store = side.Store.create(root, vocab_size=CFG.vocab_size)
        with side.session(store) as sess:
            with pytest.raises(RuntimeError, match="enable_ingest"):
                sess.append(0, [(1, 1)])
            got = {"flush": sess.flush_ingest()}
            pipe = sess.enable_ingest(auto_compact=False)
            got["idempotent"] = sess.enable_ingest() is pipe
            with pytest.raises(ValueError, match="vocab_size"):
                sess.append(0, [(CFG.vocab_size, 1)])
            got["seq"] = sess.append(0, [(CFG.vocab_size - 1, 1)])
        return got

    ref, port = _both(tmp_path, scenario)
    assert port == ref == {"flush": 0, "idempotent": True, "seq": 1}


@pytest.mark.parametrize("jb,tb", PAIRS)
def test_live_session_matches_the_reference_every_phase(tmp_path, jb, tb):
    """Appends in the memtable, in sealed deltas and after a fold: the
    port's live session gives the reference's results and stats at every
    check, and (as the reference's own test shows) a fresh store's."""
    corpus, docs = _synth_docs(90, seed=4)
    qi, qv = j_corpus.make_query(corpus, 70, CFG.max_query_nnz)

    def scenario(side, root):
        store = side.Store.create(root, vocab_size=CFG.vocab_size,
                                  docs_per_segment=16)
        store.append_docs(docs[:40])
        sess = side.session(store)
        sess.enable_ingest(seal_docs=8, fold_min_segments=3,
                           auto_compact=False)
        got = {}
        for i, (d, p) in enumerate(docs[40:], start=41):
            sess.append(d, p)
            if i in (43, 56, 90):
                got[f"r{i}"] = side.search(sess, qi[None], qv[None])
                got[f"s{i}"] = dataclasses.asdict(sess.last_stats)
        got["folded"] = sess.ingest.compact_once()
        got["after_fold"] = side.search(sess, qi[None], qv[None])
        got["ingest"] = dataclasses.asdict(sess.ingest.stats)
        got["manifest"] = dict(store.manifest)
        sess.close()
        return got

    ref, port = _both(tmp_path, scenario, _sides(jb, tb))
    _assert_equal_obs(ref, port)
    assert port["s90"]["memtable_docs"] == 90 - 40 - 48
    fresh = FlashStore.create(str(tmp_path / "fresh"),
                              vocab_size=CFG.vocab_size, docs_per_segment=16)
    fresh.append_docs(docs)
    with PORT.session(fresh) as f:
        _same(port["after_fold"], PORT.search(f, qi[None], qv[None]))


@pytest.mark.parametrize("jb,tb", PAIRS)
def test_search_under_concurrent_appends_is_prefix_consistent(tmp_path, jb,
                                                              tb):
    """Queries racing a writer with the compactor on: every search sees
    an atomic prefix of the append stream, and the end state equals the
    reference's on the same documents."""
    corpus, docs = _synth_docs(120, seed=5)
    qi, qv = j_corpus.make_query(corpus, 60, CFG.max_query_nnz)

    def scenario(side, root):
        store = side.Store.create(root, vocab_size=CFG.vocab_size,
                                  docs_per_segment=16)
        sess = side.session(store)
        sess.enable_ingest(seal_docs=8, fold_min_segments=3,
                           compact_poll_s=0.01)
        side.search(sess, qi[None], qv[None])
        stop = threading.Event()
        errs = []

        def writer():
            try:
                for d, p in docs:
                    sess.append(d, p)
            except Exception as e:            # pragma: no cover
                errs.append(e)
            finally:
                stop.set()

        t = threading.Thread(target=writer)
        t.start()
        counts = []
        while not stop.is_set():
            side.search(sess, qi[None], qv[None])
            counts.append(sess.last_stats.docs_scored)
        t.join(timeout=60)
        assert not t.is_alive() and not errs
        assert counts == sorted(counts)
        got = {"final": side.search(sess, qi[None], qv[None]),
               "docs": sess.last_stats.docs_scored,
               "sealed": store.n_docs + len(sess.ingest.memtable)}
        sess.close()
        return got

    # the background compactor folds at its own times in each package,
    # so the files may differ; this query's result does not depend on the
    # layout (the reference's test holds it to a fresh store)
    ref, port = _both(tmp_path, scenario, _sides(jb, tb), files=False)
    _assert_equal_obs(ref, port)
    assert port["docs"] == port["sealed"] == len(docs)


@pytest.mark.parametrize("jb,tb", PAIRS)
def test_submit_service_sees_appended_docs(tmp_path, jb, tb):
    corpus, docs = _synth_docs(30, seed=6)
    qi, qv = j_corpus.make_query(corpus, 17, CFG.max_query_nnz)

    def scenario(side, root):
        store = side.Store.create(root, vocab_size=CFG.vocab_size,
                                  docs_per_segment=8)
        with side.session(store) as sess:
            sess.enable_ingest(seal_docs=64, auto_compact=False)
            for d, p in docs:
                sess.append(d, p)
            Q = Query if side.port else JQuery
            row = sess.submit(Q(qi, qv)).result(timeout=60)
            return {"row": row, "stats": dataclasses.asdict(sess.last_stats)}

    ref, port = _both(tmp_path, scenario, _sides(jb, tb))
    _assert_equal_obs(ref, port)
    assert int(port["row"].doc_ids[0]) == 17
    assert port["stats"]["memtable_docs"] == 30


# ---------------------------------------------------------------------------
# each package opens the other's store and WAL
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("jb,tb", PAIRS)
def test_each_package_replays_the_others_store_and_wal(tmp_path, writer, jb,
                                                       tb):
    """One package writes a store with sealed deltas and leaves documents
    only in its WAL; the other opens it, replays the same records
    (skipping those at or below ``ingest_seq``) and searches it to the
    writer's own results."""
    corpus, docs = _synth_docs(50, seed=9)
    ref, port = _sides(jb, tb)
    w, r = (ref, port) if writer == "ref" else (port, ref)
    root = str(tmp_path / "shared")
    store = w.Store.create(root, vocab_size=CFG.vocab_size,
                           docs_per_segment=16)
    store.append_docs(docs[:20])
    sess = w.session(store)
    sess.enable_ingest(seal_docs=8, auto_compact=False)
    for d, p in docs[20:]:
        sess.append(d, p)                    # 3 seals, 6 left in the WAL
    queries = [j_corpus.make_query(corpus, i, CFG.max_query_nnz)
               for i in (3, 30, 47)]
    qi = np.stack([q[0] for q in queries])
    qv = np.stack([q[1] for q in queries])
    want = w.search(sess, qi, qv)
    want_stats = dataclasses.asdict(sess.last_stats)
    sess.close()                             # unsealed: the WAL keeps 6
    other = r.session(r.Store.open(root))
    pipe = other.enable_ingest(seal_docs=8, auto_compact=False)
    assert pipe.stats.replayed == 6
    assert [d for d, _ in pipe.memtable.docs()] == [d for d, _ in docs[44:]]
    _same(r.search(other, qi, qv), want)
    assert dataclasses.asdict(other.last_stats) == want_stats
    assert list(want.doc_ids[:, 0]) == [3, 30, 47]
    other.flush_ingest()                     # the reader seals and commits
    other.close()
    back = w.session(w.Store.open(root))
    assert back.enable_ingest(auto_compact=False).stats.replayed == 0
    _same(w.search(back, qi, qv), want)
    back.close()


# ---------------------------------------------------------------------------
# property: any op sequence, port against reference on the same sequence
# ---------------------------------------------------------------------------
_POOL_CORPUS, _POOL = _synth_docs(120, seed=42)
_OP = st.sampled_from(["append", "append", "append", "append", "append",
                       "append", "seal", "compact", "search", "crash"])


def _run_ops(side, root, ops):
    """The reference property test's loop (tests/test_ingest_property.py)
    on one package; returns each search's result and the end state."""
    def live(created):
        store = side.Store.open(root) if created else side.Store.create(
            root, vocab_size=CFG.vocab_size, docs_per_segment=8)
        sess = side.session(store)
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
                appended.append(d)
            elif op == "seal":
                sess.flush_ingest()
            elif op == "compact":
                sess.ingest.compact_once()
            elif op == "crash":
                sess.ingest.close(seal=False)
                sess.store.close()
                sess = live(True)
            elif op == "search":
                probe = _POOL[len(appended) - 1] if appended else _POOL[0]
                qi, qv = _query(probe[1])
                out.append((side.search(sess, qi, qv),
                            dataclasses.asdict(sess.last_stats)))
                assert sess.store.n_docs + len(sess.ingest.memtable) \
                    == len(appended)
        out.append(dataclasses.asdict(sess.ingest.stats))
        out.append(sess.store.manifest)
    finally:
        sess.close()
    return out


@pytest.mark.parametrize("jb,tb", PAIRS)
@settings(max_examples=3, deadline=None, derandomize=True, database=None)
@given(ops=st.lists(_OP, min_size=4, max_size=20))
@example(ops=["append", "seal", "append", "seal"])           # ROADMAP C1
@example(ops=["append"] * 4 + ["seal", "append"])            # ROADMAP C1
def test_any_interleaving_matches_the_reference(jb, tb, ops):
    tmp = tempfile.mkdtemp(prefix="torch-ingest-prop-")
    try:
        got = {}
        for side in _sides(jb, tb):
            root = os.path.join(tmp, "port" if side.port else "ref")
            got[side.port] = (_run_ops(side, root, list(ops)), _files(root))
        (ref, ref_files), (port, port_files) = got[False], got[True]
        assert port_files == ref_files
        assert port[-2:] == ref[-2:]
        for (a, sa), (b, sb) in zip(port[:-2], ref[:-2]):
            _same(a, b)
            assert sa == sb
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
