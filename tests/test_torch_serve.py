"""The port's serving tier (admission, the EDF micro-batcher, the
coalescing SearchService, ``submit`` and ``search_serve``) against the
JAX package's, on the CPU.

No test races the wall clock (ROADMAP C9): admission refills from an
injected clock; the batcher's order is read from a ``run_batch`` held
on a ``threading.Event`` until the whole backlog is queued; an expired
request is one whose deadline has passed before its flush (at submit,
or while the gate holds the loop). Results are held to serial search
and to the reference's service bit for bit (integral counts) over the
four backend pairs, the reference's Pallas kernels in interpret mode."""
import shutil
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro import serve as j_serve
from repro.configs.paper_search import SearchConfig as JConfig
from repro.configs.paper_search import smoke as j_smoke
from repro.core import corpus as j_corpus
from repro.core.engine import PatternSearchEngine as JEngine
from repro.distributed.meshctx import single_device_ctx
from repro.launch import search_serve as j_search_serve
from repro.obs import MetricsRegistry as JRegistry
from repro.storage import FlashSearchSession as JSession
from repro.storage import FlashStore as JStore
from repro.storage.store import _corpus_docs
from repro_torch import serve as t_serve
from repro_torch.configs.paper_search import SearchConfig, smoke
from repro_torch.core.engine import PatternSearchEngine
from repro_torch.launch import search_serve
from repro_torch.obs import MetricsRegistry, Obs
from repro_torch.storage import FlashSearchSession, FlashStore

torch.set_num_threads(2)
PAIRS = [("jnp", "torch"), ("pallas", "gpu"),
         ("pallas_packed", "gpu_packed"), ("pallas_fused", "gpu_fused")]
PKGS = [(j_serve, JRegistry), (t_serve, MetricsRegistry)]


class _FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _each(scenario):
    """``scenario(serve_module, registry_cls)`` in both packages; the two
    observations must be equal. Returns the port's."""
    ref, port = (scenario(*pkg) for pkg in PKGS)
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# admission: token buckets on an injected clock, the bounded queue
# ---------------------------------------------------------------------------
def test_token_bucket_burst_then_refill():
    def scenario(serve, _):
        b = serve.TokenBucket(rate=2.0, burst=3.0)
        takes = [b.try_take(t) for t in (0.0, 0.0, 0.0, 0.0, 0.5, 0.5,
                                          100.0, 100.0, 100.0, 100.0)]
        errors = []
        for kw in ({"rate": 0.0}, {"rate": 1.0, "burst": 0.5}):
            with pytest.raises(ValueError):
                serve.TokenBucket(**kw)
            errors.append(kw)
        return takes, errors

    takes, _ = _each(scenario)
    assert takes == [True, True, True, False, True, False,
                     True, True, True, False]


def test_admission_queue_full_sheds_typed_and_releases_once():
    def scenario(serve, registry_cls):
        reg = registry_cls()
        adm = serve.AdmissionController(max_pending=2, registry=reg)
        r1, r2 = adm.admit(), adm.admit()
        with pytest.raises(serve.OverloadError) as ei:
            adm.admit()
        e = ei.value
        got = [e.reason, e.depth, e.limit, e.tenant]
        r1()
        r1()                                 # exactly once: no underflow
        got.append(adm.depth)
        r3 = adm.admit()
        got += [adm.depth, adm.shed_counts(),
                reg.counter("serve_shed_total", reason="queue_full").value,
                reg.counter("serve_admitted_total").value,
                reg.gauge("serve_queue_depth").value]
        r2()
        r3()
        got.append(adm.depth)
        return got

    got = _each(scenario)
    assert got[:5] == ["queue_full", 2, 2, "default", 1]
    assert got[-1] == 0


def test_admission_quota_refills_on_injected_clock():
    def scenario(serve, _):
        clk = _FakeClock()
        adm = serve.AdmissionController(tenant_qps=1.0, tenant_burst=2.0,
                                        quotas={"vip": (100.0, 10.0)},
                                        clock=clk)
        log = []
        for tenant, dt in [("a", 0), ("a", 0), ("a", 0), ("b", 0),
                           ("a", 1.0), ("a", 0), ("vip", 0), ("a", 0.5),
                           ("a", 0.5)] + [("vip", 0)] * 10:
            clk.advance(dt)
            try:
                adm.admit(tenant)()
                log.append((tenant, "ok"))
            except serve.OverloadError as e:
                log.append((tenant, e.reason, e.tenant))
        return log, adm.shed_counts()

    log, sheds = _each(scenario)
    assert log[:6] == [("a", "ok"), ("a", "ok"), ("a", "quota", "a"),
                       ("b", "ok"), ("a", "ok"), ("a", "quota", "a")]
    # half a token, then another half: the second take succeeds
    assert log[7:9] == [("a", "quota", "a"), ("a", "ok")]
    assert sheds["quota"] >= 3 and sheds["queue_full"] == 0


def test_admission_all_none_admits_everything():
    def scenario(serve, _):
        adm = serve.AdmissionController()
        rels = [adm.admit(f"t{i}") for i in range(64)]
        depth = adm.depth
        for r in rels:
            r()
        return depth, adm.depth, adm.shed_counts()

    assert _each(scenario) == (64, 0, {"queue_full": 0, "quota": 0})


# ---------------------------------------------------------------------------
# the batcher: EDF order under a gated run_batch, typed expiry
# ---------------------------------------------------------------------------
class _Req:
    def __init__(self, tag, deadline=None, priority=0):
        self.tag = tag
        self.deadline = deadline
        self.priority = priority
        self.future = Future()


def _gated(serve, max_batch):
    """A batcher whose first batch (the plug) holds its loop on a gate."""
    gate = threading.Event()
    batches = []

    def run(reqs):
        batches.append([r.tag for r in reqs])
        for r in reqs:
            r.future.set_result(r.tag)
        if reqs[0].tag == "plug":
            assert gate.wait(timeout=30)

    mb = serve.MicroBatcher(run, max_batch=max_batch, max_delay_ms=0.0)
    plug = _Req("plug")
    mb.submit(plug)
    plug.future.result(timeout=10)           # the loop is inside run()
    return mb, gate, batches


def test_batcher_orders_the_backlog_by_priority_then_deadline():
    """With the whole backlog queued behind the plug, each flush takes the
    most urgent ``max_batch``: lower priority class first, earliest
    deadline within a class, then arrival order."""
    def scenario(serve, _):
        mb, gate, batches = _gated(serve, max_batch=2)
        base = time.monotonic() + 60.0       # deadlines far from expiring
        reqs = [_Req("bg1", priority=5), _Req("far", deadline=base + 30),
                _Req("fifo1"), _Req("near", deadline=base + 10),
                _Req("bg0", priority=5, deadline=base), _Req("fifo2"),
                _Req("urgent", priority=-1)]
        for r in reqs:
            mb.submit(r)
        pending = mb.pending_count
        gate.set()
        for r in reqs:                       # served before close() drains
            r.future.result(timeout=30)
        mb.close()
        return batches, pending, dict(mb.stats.flushes), mb.stats.n_expired

    batches, pending, flushes, expired = _each(scenario)
    assert batches == [["plug"], ["urgent", "near"], ["far", "fifo1"],
                       ["fifo2", "bg0"], ["bg1"]]
    assert pending == 7 and expired == 0
    assert flushes == {"full": 3, "timeout": 2, "deadline": 0, "drain": 0}


def test_deadline_past_at_submit_never_queues():
    def scenario(serve, _):
        batches = []

        def run(reqs):
            batches.append([r.tag for r in reqs])
            for r in reqs:
                r.future.set_result(r.tag)

        with serve.MicroBatcher(run, max_batch=4, max_delay_ms=5.0) as mb:
            r = _Req("late", deadline=time.monotonic() - 1.0)
            mb.submit(r)
            with pytest.raises(serve.DeadlineExceeded) as ei:
                r.future.result(timeout=5)
            got = [ei.value.where, ei.value.late_ms >= 1000.0,
                   mb.pending_count]
        return got + [batches, mb.stats.n_expired]

    assert _each(scenario) == ["submit", True, 0, [], 1]


def test_deadline_passed_while_queued_drops_before_scoring():
    def scenario(serve, _):
        mb, gate, batches = _gated(serve, max_batch=1)
        doomed = _Req("doomed", deadline=time.monotonic() + 0.01)
        alive = _Req("alive")
        mb.submit(doomed)
        mb.submit(alive)
        while time.monotonic() <= doomed.deadline:   # past before the flush
            time.sleep(0.005)
        gate.set()
        got = [alive.future.result(timeout=10)]
        with pytest.raises(serve.DeadlineExceeded) as ei:
            doomed.future.result(timeout=10)
        mb.close()
        return got + [ei.value.where, batches, mb.stats.n_expired]

    assert _each(scenario) == ["alive", "queue", [["plug"], ["alive"]], 1]


# ---------------------------------------------------------------------------
# SearchService: batched equals serial equals the reference
# ---------------------------------------------------------------------------
def _engines(jb, tb, n_docs=120, seed=3):
    cfg = SearchConfig(name="svc", vocab_size=600, avg_nnz_per_doc=10,
                       nnz_pad=16, top_k=4, block_docs=16, block_query=32)
    jcfg = JConfig(name="svc", vocab_size=600, avg_nnz_per_doc=10,
                   nnz_pad=16, top_k=4, block_docs=16, block_query=32)
    corpus = j_corpus.synthesize(n_docs, cfg.vocab_size, 10, cfg.nnz_pad,
                                 seed=seed)
    ref = JEngine(corpus, jcfg, single_device_ctx(), backend=jb)
    port = PatternSearchEngine(corpus, cfg, "cpu", tb)
    return ref, port, corpus


def _serve_all(serve, searcher, queries, **kw):
    """Every query through one SearchService from four client threads."""
    rows = [None] * len(queries)
    with serve.SearchService(searcher, **kw) as svc:
        def client(t):
            for i in range(t, len(queries), 4):
                rows[i] = svc.submit(serve.Query(*queries[i])).result(
                    timeout=120)
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        stats = svc.stats
    return rows, stats


def _same_row(got, want, label=""):
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids, label)
    np.testing.assert_array_equal(np.asarray(got.scores).view(np.uint32),
                                  np.asarray(want.scores).view(np.uint32),
                                  label)


@pytest.mark.parametrize("jb,tb", PAIRS)
def test_service_over_the_engine_equals_serial_and_the_reference(jb, tb):
    ref, port, corpus = _engines(jb, tb)
    queries = [j_corpus.make_query(corpus, i, 12) for i in range(0, 120, 7)]
    got, st = _serve_all(t_serve, port, queries, max_batch=4,
                         max_delay_ms=1.0)
    want, _ = _serve_all(j_serve, ref, queries, max_batch=4,
                         max_delay_ms=1.0)
    for i, (qi, qv) in enumerate(queries):
        serial = port.search_typed(t_serve.Query(qi, qv))
        _same_row(got[i], serial.__class__(serial.doc_ids[0],
                                           serial.scores[0]), f"serial {i}")
        _same_row(got[i], want[i], f"reference {i}")
        assert int(got[i].doc_ids[0]) == 7 * i
    assert st.n_requests == len(queries)
    assert 1 <= st.n_batches <= len(queries)


@pytest.mark.parametrize("jb,tb", PAIRS)
def test_service_over_a_live_store_equals_serial_and_the_reference(
        tmp_path, jb, tb):
    """Coalesced batches over a store with sealed deltas and a memtable:
    each row equals the session's serial search and the reference
    session's service row, and the stats of a batch match."""
    cfg = smoke()
    corpus = j_corpus.synthesize(70, cfg.vocab_size, cfg.avg_nnz_per_doc,
                                 cfg.nnz_pad, seed=11)
    docs = _corpus_docs(corpus)
    queries = [j_corpus.make_query(corpus, i, cfg.max_query_nnz)
               for i in (2, 20, 41, 55, 63, 69)]
    rows = {}
    for port in (False, True):
        root = str(tmp_path / ("port" if port else "ref"))
        store = (FlashStore if port else JStore).create(
            root, vocab_size=cfg.vocab_size, docs_per_segment=16)
        store.append_docs(docs[:32])
        sess = (FlashSearchSession(store, cfg, "cpu", tb) if port
                else JSession(store, j_smoke(), backend=jb))
        sess.enable_ingest(seal_docs=8, auto_compact=False)
        for d, p in docs[32:]:
            sess.append(d, p)               # 4 seals, 6 in the memtable
        serve = t_serve if port else j_serve
        got, _ = _serve_all(serve, sess, queries, max_batch=4,
                            max_delay_ms=1.0)
        serial = [sess.search_typed(serve.Query(qi[None], qv[None]))
                  for qi, qv in queries]
        assert sess.last_stats.memtable_docs == 6
        for g, s in zip(got, serial):
            _same_row(g, s.__class__(s.doc_ids[0], s.scores[0]))
        rows[port] = got
        sess.close()
    for i, (a, b) in enumerate(zip(rows[True], rows[False])):
        _same_row(a, b, f"query {i}")
    assert [int(r.doc_ids[0]) for r in rows[True]] == [2, 20, 41, 55, 63, 69]


def test_submit_typed_and_positional_forms_match_the_reference(tmp_path):
    """``session.submit``: the typed form resolves to a SearchResponse
    (results truncated to ``k``, the request's QueryStats), the
    positional arrays to the bare row with a DeprecationWarning; an
    expired deadline fails the Future typed, and the service serves on."""
    cfg = smoke()
    corpus = j_corpus.synthesize(40, cfg.vocab_size, cfg.avg_nnz_per_doc,
                                 cfg.nnz_pad, seed=12)
    qi, qv = j_corpus.make_query(corpus, 9, cfg.max_query_nnz)
    out = {}
    for port in (False, True):
        root = str(tmp_path / ("port" if port else "ref"))
        store = (FlashStore if port else JStore).create(
            root, vocab_size=cfg.vocab_size, docs_per_segment=16)
        store.append_docs(_corpus_docs(corpus))
        serve = t_serve if port else j_serve
        sess = (FlashSearchSession(store, cfg, "cpu", "torch") if port
                else JSession(store, j_smoke()))
        opts = serve.QueryOptions(k=2, deadline_ms=60_000.0, tenant="t1")
        resp = sess.submit(serve.Query(qi, qv), options=opts).result(60)
        with pytest.warns(DeprecationWarning):
            bare = sess.submit(qi, qv).result(timeout=60)
        late = sess.submit(serve.Query(qi, qv),
                           options=serve.QueryOptions(deadline_ms=-1.0))
        with pytest.raises(serve.DeadlineExceeded) as ei:
            late.result(timeout=60)
        assert type(resp).__name__ == "SearchResponse"
        assert type(bare).__name__ == "SearchResult"
        assert resp.stats.queue_wait_ms >= 0.0
        out[port] = (resp.doc_ids.tolist(), resp.scores.tolist(),
                     resp.stats.deadline_ms, resp.stats.tenant,
                     resp.stats.partial, resp.stats.hedged,
                     bare.doc_ids.tolist(), bare.scores.tolist(),
                     ei.value.where, sess.service().stats.n_expired)
        sess.close()
    assert out[True] == out[False]
    assert out[True][0][0] == 9 and len(out[True][0]) == 2


def test_engine_counts_new_launch_keys_in_its_registry():
    """The engine's obs hookup: ``engine_compile_traces`` counts each
    new launch key (a jit trace in the reference), and the device fence
    splits the score into dispatch and device stages."""
    _, port, corpus = _engines("jnp", "gpu")
    obs = Obs(device_fence=True)
    eng = PatternSearchEngine(corpus, port.cfg, "cpu", "gpu", obs=obs)
    for L in (1, 2, 3, 4, 1):
        qs = [j_corpus.make_query(corpus, i, 12) for i in range(L)]
        eng.search_typed(t_serve.Query(np.stack([q[0] for q in qs]),
                                       np.stack([q[1] for q in qs])))
    reg = obs.registry
    assert eng.compile_stats["n_traces"] == 3           # L buckets 1, 2, 4
    assert reg.counter("engine_compile_traces").value == 3
    for stage in ("score_dispatch", "score_device"):
        assert reg.histogram("stage_ms", stage=stage).count == 5


# ---------------------------------------------------------------------------
# search_serve: the launcher on the CPU, its metric names the reference's
# ---------------------------------------------------------------------------
# a vocabulary of 64 words: every segment (and every 16-document delta)
# holds some word of every query, so no run skips a segment by its filter
# and the two runs' counters cannot differ by when a seal landed
SERVE_ARGS = ["--vocab", "64", "--avg-nnz", "12", "--nnz-pad", "16",
              "--query-nnz", "16", "--top-k", "4", "--clients", "3",
              "--requests", "4", "--max-batch", "4", "--ingest", "40",
              "--seal-docs", "16"]


def _metric_names(path):
    return sorted(line.split()[2] for line in open(path)
                  if line.startswith("# TYPE"))


def test_search_serve_with_ingest_writes_the_reference_metric_names(
        tmp_path, monkeypatch, capsys):
    corpus = j_corpus.synthesize(96, 64, 12, 16, seed=13)
    base = str(tmp_path / "base")
    store = FlashStore.create(base, vocab_size=64, docs_per_segment=32)
    store.append_corpus(corpus)
    store.close()
    roots = {}
    for who in ("ref", "port"):
        roots[who] = str(tmp_path / who)
        shutil.copytree(base, roots[who])
    out = search_serve.main(SERVE_ARGS + [
        "--store", roots["port"], "--device", "cpu", "--backend", "torch",
        "--metrics-out", str(tmp_path / "port.prom")])
    monkeypatch.setattr(sys, "argv", ["search_serve"] + SERVE_ARGS + [
        "--store", roots["ref"], "--backend", "jnp",
        "--metrics-out", str(tmp_path / "ref.prom")])
    j_search_serve.main()
    text = capsys.readouterr().out
    assert "engine traces:" in text and "ingest: 40 docs appended" in text
    names = _metric_names(tmp_path / "port.prom")
    assert names == _metric_names(tmp_path / "ref.prom")
    assert "repro_ingest_seals" in names and \
        "repro_serve_queue_wait_ms" in names
    assert out["queries"] == 12 and out["appended"] == 40
    assert out["seals"] >= 2 and out["device"] == "cpu"
    assert out["post_docs_scored"] == 96 + 40
    assert FlashStore.open(roots["port"]).n_docs + 40 % 16 == 96 + 40


def test_search_serve_resident_serial_and_fenced(capsys):
    out = search_serve.main(["--n-docs", "200", "--vocab", "512",
                             "--avg-nnz", "12", "--nnz-pad", "16",
                             "--query-nnz", "12", "--clients", "2",
                             "--requests", "3", "--serial",
                             "--device-fence", "--device", "cpu"])
    assert out["target"] == "resident" and out["queries"] == 6
    reg = out["obs"].registry
    assert reg.histogram("stage_ms", stage="score_device").count >= 6
    assert "[serial]" in capsys.readouterr().out


@pytest.mark.parametrize("flag,queue", [
    (["--telemetry-port", "0"], "A6"), (["--profile-dir", "p"], "A6")])
def test_search_serve_flags_of_later_queues_exit_naming_them(flag, queue,
                                                            capsys,
                                                            tmp_path):
    """Queue A6 is ported: its flags no longer exit naming it. With
    ``--telemetry-port`` the run serves the plane and returns its URL
    and each stock objective's final state; ``--profile-dir`` alone arms
    nothing, as in the reference (it needs ``--telemetry-port``)."""
    if flag[0] == "--profile-dir":
        flag = [flag[0], str(tmp_path / flag[1])]
    out = search_serve.main(["--n-docs", "200", "--vocab", "512",
                             "--avg-nnz", "12", "--nnz-pad", "16",
                             "--query-nnz", "12", "--clients", "2",
                             "--requests", "3", "--device", "cpu",
                             "--slo-ms", "60000", "--slo-target", "0.9"]
                            + flag)
    captured = capsys.readouterr()
    assert queue not in captured.err and out["queries"] == 6
    served = flag[0] == "--telemetry-port"
    assert ("telemetry_url" in out) == served
    assert ("[serve] telemetry: http://127.0.0.1:" in captured.out) == served
    assert ("slo serve-latency: ok" in captured.out) == served
    if served:
        assert sorted(out["slo"]) == ["serve-availability", "serve-latency"]
        lat = out["slo"]["serve-latency"]
        assert lat["state"] == "ok" and lat["target"] == 0.9
        assert lat["window_events"] == 6
        assert lat["detail"] == "query_ms p<= 60000ms"
    assert not (tmp_path / "p").exists()


def test_search_serve_on_a_cluster_writes_the_reference_metric_names(
        tmp_path, monkeypatch, capsys):
    """``--cluster`` with ``--hedge-percentile`` and ``--allow-partial``
    (a 2 x 2 cluster on the CPU, the same directory for both runs) and
    ``--ingest`` through the cluster's write path: the port's metric
    names are the reference's."""
    from repro.cluster import build_sharded_store as j_build
    corpus = j_corpus.synthesize(96, 64, 12, 16, seed=13)
    base = str(tmp_path / "base")
    j_build(base, _corpus_docs(corpus), n_shards=2, replicas=2,
            vocab_size=64, docs_per_segment=32)
    roots = {}
    for who in ("ref", "port"):
        roots[who] = str(tmp_path / who)
        shutil.copytree(base, roots[who])
    flags = ["--hedge-percentile", "0.95", "--allow-partial"]
    out = search_serve.main(SERVE_ARGS + flags + [
        "--cluster", roots["port"], "--device", "cpu", "--backend", "torch",
        "--metrics-out", str(tmp_path / "port.prom")])
    monkeypatch.setattr(sys, "argv", ["search_serve"] + SERVE_ARGS + flags + [
        "--cluster", roots["ref"], "--backend", "jnp",
        "--metrics-out", str(tmp_path / "ref.prom")])
    j_search_serve.main()
    text = capsys.readouterr().out
    assert text.count("2 shards x 2 replicas, 96 docs") == 2
    assert text.count("router lifetime: 0 replicas failed over") == 2
    # whether a hedge fires depends on this run's shard times against
    # their own rolling p95, so its two counters are held to the run's
    # count, and every other name to the reference's
    hedge_names = {"repro_cluster_hedges_total",
                   "repro_cluster_hedge_wins_total"}
    names = set(_metric_names(tmp_path / "port.prom"))
    ref_names = set(_metric_names(tmp_path / "ref.prom"))
    assert names - hedge_names == ref_names - hedge_names
    assert ("repro_cluster_hedges_total" in names) == (out["hedges"] > 0)
    assert ("repro_cluster_hedge_wins_total" in names) == (
        out["hedge_wins"] > 0)
    assert "repro_cluster_shard_ms" in names
    assert out["target"] == "cluster" and out["queries"] == 12
    assert out["appended"] == 40 and out["post_docs_scored"] == 96 + 40
    assert out["failovers"] == 0 and out["partial"] == 0
    assert 0 <= out["hedge_wins"] <= out["hedges"]
