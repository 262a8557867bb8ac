"""The port's telemetry HTTP server (``repro_torch.obs.server``) against
the JAX package's, on the CPU: a ``device="cpu"`` store and a 2 x 2
cluster.

- ``/metrics`` and ``/slo`` bodies equal the reference's on the same
  observations and one injected clock;
- ``/healthz`` payloads equal the reference's, down to the killed
  replica's 503;
- results bit-identical while scraped, 409 without ``profile_dir``, 423
  during a capture, and a CPU ``/debug/profile`` capture, started from
  the HTTP thread, that records another thread's ops and prints no
  ``External init callback``;
- a scrape loop that stays at 200 while a writer appends and seals past
  the compactor's fold, on a store opened from a ``pathlib.Path``: the
  reference's ``/healthz`` answers 500 there (ROADMAP C14);
- the reference test file's exporter and rendering cases.
No test asserts a duration (ROADMAP C9)."""
import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.cluster import FlashClusterSession as JClusterSession
from repro.cluster.store import build_sharded_store
from repro.configs.paper_search import smoke as j_smoke
from repro.core import corpus as j_corpus
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Obs as JObs
from repro.obs import server as j_server
from repro.obs import slo as j_slo
from repro.storage import FlashSearchSession as JSession
from repro.storage import FlashStore as JStore
from repro.storage.store import _corpus_docs
from repro_torch.cluster import FlashClusterSession
from repro_torch.configs.paper_search import smoke
from repro_torch.obs import MetricsRegistry, Obs, QueryTrace
from repro_torch.obs import server as t_server
from repro_torch.obs import slo as t_slo
from repro_torch.obs.export import (render_summary, render_trace,
                                    write_metrics, write_traces)
from repro_torch.obs.server import TelemetryServer, aggregate_health
from repro_torch.obs.slo import SLOMonitor, default_slos
from repro_torch.serve import Query
from repro_torch.storage import FlashSearchSession, FlashStore
from tests.test_obs_window import FakeClock

torch.set_num_threads(2)
CFG = smoke()
J_CFG = j_smoke()
ROUTES = ("/metrics", "/healthz", "/slo", "/debug/traces")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    corpus = j_corpus.synthesize(400, CFG.vocab_size, CFG.avg_nnz_per_doc,
                                 CFG.nnz_pad, seed=11)
    root = str(tmp_path_factory.mktemp("srv") / "store")
    store = FlashStore.create(root, vocab_size=CFG.vocab_size,
                              docs_per_segment=100)
    store.append_corpus(corpus)
    store.close()
    return corpus, root


def _query(corpus, idx=7):
    qi, qv = j_corpus.make_query(corpus, idx, CFG.max_query_nnz)
    return qi[None], qv[None]


def _get(url):
    """(status, body) — urllib raises on 4xx/5xx but the HTTPError *is*
    the response."""
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# -- health aggregation ------------------------------------------------

@pytest.mark.parametrize("components,want", [
    ({}, "ok"), ({"a": {"status": "ok"}}, "ok"),
    ({"a": {"status": "ok"}, "b": {"status": "degraded"}}, "degraded"),
    ({"a": {"status": "degraded"}, "b": {"status": "down"}}, "down"),
    ({"a": {}}, "down"),                                # missing status
    ({"a": {"status": "garbage"}}, "down")])
def test_aggregate_health_worst_of(components, want):
    assert aggregate_health(components) == want
    assert j_server.aggregate_health(components) == want


# -- /metrics and /slo against the reference, one injected clock --------

def test_metrics_and_slo_bodies_equal_the_reference():
    clock = FakeClock(100.0)
    servers = {}
    for key, obs_cls, reg_cls, slo_mod, srv_mod in (
            ("ref", JObs, JRegistry, j_slo, j_server),
            ("port", Obs, MetricsRegistry, t_slo, t_server)):
        obs = obs_cls(registry=reg_cls(window_s=10.0, window_slices=5,
                                       clock=clock))
        mon = slo_mod.SLOMonitor(obs, slo_mod.default_slos(
            "store", latency_ms=100.0, latency_target=0.9))
        servers[key] = srv_mod.TelemetryServer(obs, slo_monitor=mon)
    try:
        rng = np.random.default_rng(5)
        steps = [rng.gamma(2.0, 40.0, 60) for _ in range(3)]
        for i, lat in enumerate(steps):
            for srv in servers.values():
                reg = srv.obs.registry
                for v in lat:
                    reg.histogram("query_ms", surface="store").observe(v)
                    reg.histogram("stage_ms", stage="score").observe(v / 7)
                reg.counter("queries_total", surface="store").inc(len(lat))
                reg.counter("query_errors_total", surface="store").inc(i)
                reg.gauge("slab_cache_bytes").set(1 << (20 + i))
            bodies = {k: {r: _get(s.url(r)) for r in
                          ("/slo", "/metrics", "/debug/traces", "/nope")}
                      for k, s in servers.items()}
            assert bodies["port"] == bodies["ref"]
            assert bodies["port"]["/metrics"][0] == 200
            assert "repro_slo_state" in bodies["port"]["/metrics"][1]
            assert bodies["port"]["/nope"][0] == 404
            clock.advance(4.0)     # the windows rotate between the steps
        slos = json.loads(bodies["port"]["/slo"][1])["slos"]
        assert [s["window_events"] for s in slos] == [180, 180]
    finally:
        for srv in servers.values():
            srv.close()


# -- store session endpoints -------------------------------------------

def test_store_endpoints_well_formed(setup):
    corpus, root = setup
    obs = Obs(trace_sample=1)
    mon = SLOMonitor(obs, default_slos("store", latency_ms=60_000.0))
    sess = FlashSearchSession(FlashStore.open(root), CFG, "cpu", obs=obs)
    srv = sess.start_telemetry(slo_monitor=mon)
    assert sess.start_telemetry() is srv       # idempotent
    assert sess.telemetry is srv
    sess.search(*_query(corpus))

    code, body = _get(srv.url("/metrics"))
    assert code == 200
    assert "# TYPE repro_query_ms histogram" in body
    assert 'repro_queries_total{surface="store"} 1' in body
    assert 'stat="p99"' in body                # window gauges included

    code, body = _get(srv.url("/healthz"))
    health = json.loads(body)
    assert code == 200 and health["status"] == "ok"
    assert "ingest" in health["components"]    # store surface: WAL probe

    code, body = _get(srv.url("/slo"))
    slos = json.loads(body)["slos"]
    assert code == 200 and len(slos) == 2
    assert {s["kind"] for s in slos} == {"latency", "availability"}
    assert all(s["state"] == "ok" for s in slos)

    code, body = _get(srv.url("/debug/traces"))
    dump = json.loads(body)
    assert code == 200 and dump["schema"] == "repro-traces-v1"
    assert dump["traces"][0]["root"]["name"] == "query"

    code, body = _get(srv.url("/debug/profile"))
    assert code == 409                         # no profile_dir configured
    assert "profiling disabled" in json.loads(body)["error"]

    code, body = _get(srv.url("/nope"))
    assert code == 404
    assert "/metrics" in json.loads(body)["routes"]

    port = srv.port
    sess.close()                               # closes the server too
    assert sess.telemetry is None
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                               timeout=2)
    with pytest.raises(RuntimeError):
        sess.start_telemetry()                 # closed session refuses


def test_store_healthz_payload_equals_the_reference(setup, tmp_path):
    """The same store (two copies) with an ingest pipeline on each
    package's session: equal payloads but for each copy's root."""
    _, root = setup
    payloads = {}
    for key, sess_cls, cfg, kw in (("ref", JSession, J_CFG, {}),
                                   ("port", FlashSearchSession, CFG,
                                    {"device": "cpu"})):
        path = str(tmp_path / key)
        shutil.copytree(root, path)
        store_cls = JStore if key == "ref" else FlashStore
        sess = sess_cls(store_cls.open(path), cfg, **kw)
        srv = sess.start_telemetry()
        before = _get(srv.url("/healthz"))
        sess.enable_ingest(seal_docs=8, auto_compact=False)
        sess.append(10_000, [(1, 2), (3, 4)])
        code, body = _get(srv.url("/healthz"))
        payload = json.loads(body)
        assert payload["components"]["ingest"]["detail"][0].pop(
            "root") == path
        payloads[key] = (before, code, payload)
        sess.close()
    assert payloads["port"] == payloads["ref"]
    assert payloads["port"][1] == 200
    assert payloads["port"][2]["components"]["ingest"]["detail"] == [
        {"closed": False, "compactor_alive": False, "wal_seq": 1,
         "memtable_docs": 1}]


# -- the killed-replica /healthz flip ----------------------------------

def _kill_replica(cl, sess, shard, rep):
    shutil.rmtree(cl.shard_path(shard, rep))
    cl._open_stores.pop((shard, rep), None)
    with sess.router._lock:
        stale = sess.router._sessions[shard][rep]
        sess.router._sessions[shard][rep] = None
    if stale is not None:
        stale.close()


def test_cluster_healthz_flips_on_killed_replica_as_the_reference(
        setup, tmp_path):
    corpus, _ = setup
    base = str(tmp_path / "base")
    build_sharded_store(base, _corpus_docs(corpus), n_shards=2, replicas=2,
                        vocab_size=CFG.vocab_size, docs_per_segment=100)
    seen = {}
    for key, sess_cls, cfg, kw in (("ref", JClusterSession, J_CFG, {}),
                                   ("port", FlashClusterSession, CFG,
                                    {"device": "cpu"})):
        path = str(tmp_path / key)
        shutil.copytree(base, path)
        sess = sess_cls(path, cfg, obs=(JObs if key == "ref" else Obs)(),
                        **kw)
        srv = sess.start_telemetry()
        qi, qv = _query(corpus)
        baseline = sess.search(qi, qv)
        steps = [_get(srv.url("/healthz"))]
        _kill_replica(sess.router.store, sess, 0, 0)
        r = sess.search(qi, qv)
        np.testing.assert_array_equal(r.doc_ids, baseline.doc_ids)
        np.testing.assert_array_equal(r.scores, baseline.scores)
        steps.append(_get(srv.url("/healthz")))
        sess.router.mark_down(0, 1)
        steps.append(_get(srv.url("/healthz")))
        code, body = _get(srv.url("/metrics"))
        assert code == 200 and "repro_cluster_shard_ms" in body
        code, body = _get(srv.url("/slo"))
        assert code == 200 and json.loads(body)["slos"] == []
        seen[key] = [(c, json.loads(b)) for c, b in steps]
        sess.close()
    assert seen["port"] == seen["ref"]
    (c0, h0), (c1, h1), (c2, h2) = seen["port"]
    assert c0 == 200 and h0["status"] == "ok"
    assert h0["components"]["router"]["replicas_down"] == 0
    assert c1 == 200 and h1["status"] == "degraded"   # degraded serves
    router = h1["components"]["router"]
    assert router["replicas_down"] == 1 and router["dead_shards"] == []
    assert router["failovers"] >= 1
    assert router["rotation"][0] == [False, True]
    assert c2 == 503 and h2["status"] == "down"
    assert h2["components"]["router"]["dead_shards"] == [0]


# -- the live-scrape differential --------------------------------------

def test_results_bit_identical_while_scraped(setup):
    corpus, root = setup
    off = FlashSearchSession(FlashStore.open(root), CFG, "cpu",
                             obs=Obs.disabled())
    on = FlashSearchSession(FlashStore.open(root), CFG, "cpu",
                            obs=Obs(trace_sample=1))
    srv = on.start_telemetry()
    stop = threading.Event()
    codes = []

    def scraper():
        while not stop.is_set():
            code, body = _get(srv.url("/metrics"))
            codes.append((code, body.endswith("\n")))
            codes.append((_get(srv.url("/healthz"))[0], True))
            stop.wait(0.005)

    t = threading.Thread(target=scraper, daemon=True)
    t.start()
    try:
        for idx in (0, 57, 123, 399):
            qi, qv = _query(corpus, idx)
            a, b = on.search(qi, qv), off.search(qi, qv)
            np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
            np.testing.assert_array_equal(a.scores, b.scores)
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and codes
    assert set(codes) == {(200, True)}
    on.close()
    off.close()


# -- scrapes under writes (PR 19's 500) --------------------------------

def test_scrapes_stay_200_while_a_writer_seals_past_a_fold(setup, tmp_path):
    """Four routes scraped in a loop while a writer appends (a seal every
    8 documents) until the compactor has folded, on a store opened from
    a ``pathlib.Path``: every answer is 200, and the ingest probe reports
    the root as a string."""
    corpus, root = setup
    path = tmp_path / "live"
    shutil.copytree(root, path)
    obs = Obs(trace_sample=1)
    sess = FlashSearchSession(FlashStore.open(path), CFG, "cpu", obs=obs)
    pipe = sess.enable_ingest(seal_docs=8, compact_poll_s=0.01)
    srv = sess.start_telemetry(slo_monitor=SLOMonitor(
        obs, default_slos("store", latency_ms=250.0)))
    new = j_corpus.synthesize(400, CFG.vocab_size, CFG.avg_nnz_per_doc,
                              CFG.nnz_pad, seed=3)
    stop = threading.Event()
    codes, bad = {}, []

    def scraper():
        while not stop.is_set():
            for route in ROUTES:
                code, body = _get(srv.url(route))
                codes[route, code] = codes.get((route, code), 0) + 1
                if code != 200:
                    bad.append((route, code, body[:400]))

    def client():
        for j in range(12):
            sess.submit(Query(*j_corpus.make_query(
                corpus, j * 31 % 400, CFG.max_query_nnz))).result(timeout=60)

    threads = [threading.Thread(target=scraper, daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()
    reader = threading.Thread(target=client)
    reader.start()
    try:
        for r in range(new.n_docs):
            sess.append(50_000 + r, [(int(w), int(v)) for w, v in zip(
                new.ids[r], new.vals[r]) if w >= 0])
            if pipe.stats.compactions >= 1 and r >= 64:
                break
        reader.join(timeout=120)
        code, body = _get(srv.url("/healthz"))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not reader.is_alive() and not any(t.is_alive() for t in threads)
    assert pipe.stats.seals >= 8 and pipe.stats.compactions >= 1
    assert not bad, bad
    assert {c for _, c in codes} == {200}
    assert all(codes.get((route, 200), 0) >= 1 for route in ROUTES)
    detail = json.loads(body)["components"]["ingest"]["detail"]
    assert code == 200 and detail[0]["root"] == str(path)
    sess.close()


def test_the_reference_healthz_answers_500_on_a_path_root(setup, tmp_path):
    """ROADMAP C14: the reference's ingest probe puts ``store.root`` in
    the JSON as it was given; a ``pathlib.Path`` cannot be serialized, so
    its ``/healthz`` answers 500 once a pipeline is attached. The port's
    answers 200 with the root as a string."""
    _, root = setup
    seen = {}
    for key, sess_cls, store_cls, cfg, kw in (
            ("ref", JSession, JStore, J_CFG, {}),
            ("port", FlashSearchSession, FlashStore, CFG,
             {"device": "cpu"})):
        path = tmp_path / key
        shutil.copytree(root, path)
        sess = sess_cls(store_cls.open(path), cfg, **kw)
        srv = sess.start_telemetry()
        no_ingest = _get(srv.url("/healthz"))[0]
        sess.enable_ingest(auto_compact=False)
        code, body = _get(srv.url("/healthz"))
        seen[key] = (no_ingest, code, body)
        sess.close()
    assert seen["ref"][:2] == (200, 500)
    assert "not JSON serializable" in seen["ref"][2]
    assert seen["port"][:2] == (200, 200)
    assert json.loads(seen["port"][2])["components"]["ingest"]["detail"][
        0]["root"] == str(tmp_path / "port")


# -- /debug/profile ----------------------------------------------------

def test_profile_capture_from_the_http_thread_records_other_threads(
        setup, tmp_path, capfd):
    """A CPU capture started on the HTTP thread records the ops of a
    thread that searches beside it, and Kineto prints no ``External
    init callback`` error."""
    corpus, root = setup
    sess = FlashSearchSession(FlashStore.open(root), CFG, "cpu", obs=Obs())
    srv = sess.start_telemetry(profile_dir=str(tmp_path / "prof"))
    stop = threading.Event()
    searched = []

    def load():
        while not stop.is_set():
            searched.append(sess.search(*_query(corpus)))

    t = threading.Thread(target=load, name="search-load")
    t.start()
    try:
        while not searched:
            stop.wait(0.01)
        code, body = _get(srv.url("/debug/profile?ms=300"))
    finally:
        stop.set()
        t.join(timeout=60)
    assert code == 200, body
    ans = json.loads(body)
    assert ans["captured_ms"] == 300 and ans["dir"] == str(tmp_path / "prof")
    assert os.path.dirname(ans["file"]) == ans["dir"]
    events = json.load(open(ans["file"]))["traceEvents"]
    other = [e for e in events if e.get("cat") == "cpu_op"
             and e.get("tid") != ans["thread"]]
    assert other, "the capture recorded no op of the searching thread"
    assert "External init callback" not in capfd.readouterr().err
    sess.close()


@pytest.mark.parametrize("ms,clamped", [("0", 1), ("25", 25),
                                         ("99999", 10_000)])
def test_profile_ms_is_clamped(tmp_path, monkeypatch, ms, clamped):
    srv = TelemetryServer(Obs(), profile_dir=str(tmp_path))
    taken = []
    monkeypatch.setattr(srv, "capture", lambda m: taken.append(m) or "f")
    try:
        code, body = _get(srv.url(f"/debug/profile?ms={ms}"))
    finally:
        srv.close()
    assert code == 200 and taken == [clamped]
    assert json.loads(body)["captured_ms"] == clamped


def test_a_second_capture_answers_423_while_one_runs(tmp_path, monkeypatch):
    srv = TelemetryServer(Obs(), profile_dir=str(tmp_path))
    entered, release = threading.Event(), threading.Event()

    def held(ms):
        entered.set()
        release.wait(60)
        return "f"

    monkeypatch.setattr(srv, "capture", held)
    first = {}
    t = threading.Thread(target=lambda: first.update(
        r=_get(srv.url("/debug/profile?ms=50"))))
    t.start()
    try:
        assert entered.wait(60)
        code, body = _get(srv.url("/debug/profile"))
    finally:
        release.set()
        t.join(timeout=60)
        srv.close()
    assert code == 423 and "already running" in json.loads(body)["error"]
    assert first["r"][0] == 200


def test_a_failed_capture_answers_500(tmp_path, monkeypatch):
    srv = TelemetryServer(Obs(), profile_dir=str(tmp_path))

    def broken(ms):
        raise RuntimeError("no profiler")

    monkeypatch.setattr(srv, "capture", broken)
    try:
        code, body = _get(srv.url("/debug/profile"))
        again = _get(srv.url("/metrics"))[0]
    finally:
        srv.close()
    assert code == 500 and "profiler failed" in json.loads(body)["error"]
    assert again == 200                        # the lock was released


def test_capture_activities_follow_the_searchers_device(setup):
    corpus, root = setup
    acts = t_server.profiler_activities
    assert [a.name for a in acts(None)] == ["CPU"]
    assert [a.name for a in acts("cpu")] == ["CPU"]
    assert [a.name for a in acts(torch.device("cuda", 0))] == ["CPU", "CUDA"]
    sess = FlashSearchSession(FlashStore.open(root), CFG, "cpu", obs=Obs())
    assert t_server.searcher_device(sess) == torch.device("cpu")
    sess.close()


# -- atomic exporters --------------------------------------------------

def test_exporters_are_atomic_no_tmp_residue(setup, tmp_path):
    corpus, root = setup
    obs = Obs(trace_sample=1)
    sess = FlashSearchSession(FlashStore.open(root), CFG, "cpu", obs=obs)
    sess.search(*_query(corpus))
    mpath = str(tmp_path / "metrics.prom")
    tpath = str(tmp_path / "traces.json")
    for _ in range(3):                         # overwrite path too
        write_metrics(obs, mpath)
        assert write_traces(obs, tpath) >= 1
    assert not os.path.exists(mpath + ".tmp")
    assert not os.path.exists(tpath + ".tmp")
    assert "repro_query_ms" in open(mpath).read()
    assert json.load(open(tpath))["schema"] == "repro-traces-v1"
    sess.close()


# -- rendering edge cases ----------------------------------------------

def test_render_summary_zero_queries_is_complete():
    class Bare:
        pass
    out = render_summary(Bare(), Obs())
    assert "== observability summary ==" in out
    assert "no queries served" in out          # not a bare header


def test_render_summary_includes_window_and_slo_lines(setup):
    corpus, root = setup
    obs = Obs()
    mon = SLOMonitor(obs, default_slos("store", latency_ms=60_000.0))
    sess = FlashSearchSession(FlashStore.open(root), CFG, "cpu", obs=obs)
    sess.search(*_query(corpus))
    out = render_summary(sess, obs, slo_monitor=mon)
    assert "last 60s: n=1" in out              # the rolling-window line
    assert "slo store-latency: ok" in out
    assert "slo store-availability: ok" in out
    sess.close()


def test_render_trace_sub_100us_spans_in_microseconds():
    tr = QueryTrace("query", surface="test")
    with tr.root.child("merge") as m:
        m.set(docs=0)
    tr.finish()
    d = tr.to_dict()["root"]
    d["children"][0]["dur_ms"] = 0.0123        # a 12.3 µs no-op merge
    d["dur_ms"] = 1.5

    class Fake:
        def to_dict(self):
            return {"root": d}

    out = render_trace(Fake())
    assert "12.3µs" in out                     # not 0.000ms
    assert "1.500ms" in out


# -- the launch gate a capture starts and stops behind (ROADMAP C16) ----

def test_quiesced_waits_for_launches_and_holds_new_ones_off():
    from repro_torch.device import LaunchGate
    gate = LaunchGate()
    inside, release = threading.Event(), threading.Event()
    order = []

    def launcher(name, entered=None, hold=None):
        with gate.launching():
            order.append(name)
            if entered is not None:
                entered.set()
            if hold is not None:
                hold.wait(60)

    a = threading.Thread(target=launcher, args=("a", inside, release))
    a.start()
    assert inside.wait(60)
    quiet = threading.Event()

    def writer():
        with gate.quiesced():
            order.append("quiesced")
            quiet.set()
            late_released.wait(60)

    late_released = threading.Event()
    w = threading.Thread(target=writer)
    w.start()
    assert not quiet.wait(0.2)          # a launch is still inside
    release.set()
    assert quiet.wait(60)
    b = threading.Thread(target=launcher, args=("b",))
    b.start()
    b.join(0.2)
    assert b.is_alive() and order == ["a", "quiesced"]   # held off
    late_released.set()
    for t in (a, w, b):
        t.join(60)
        assert not t.is_alive()
    assert order == ["a", "quiesced", "b"]


def test_a_nested_launch_never_waits_behind_a_waiting_quiesce():
    """A thread inside ``launching`` re-enters it (a search's uploads)
    while a quiesce waits for it: no deadlock."""
    from repro_torch.device import LaunchGate
    gate = LaunchGate()
    entered, nested_done, waiting = (threading.Event() for _ in range(3))

    def search():
        with gate.launching():
            entered.set()
            waiting.wait(60)
            with gate.launching():      # the quiesce below is waiting
                nested_done.set()

    s = threading.Thread(target=search)
    s.start()
    assert entered.wait(60)
    w = threading.Thread(target=lambda: gate.quiesced().__enter__())
    w.start()
    w.join(0.1)
    waiting.set()
    assert nested_done.wait(60)
    s.join(60)
    w.join(60)
    assert not s.is_alive() and not w.is_alive()


def test_no_launch_is_inside_while_quiesced_under_contention():
    import sys
    from repro_torch.device import LaunchGate
    gate = LaunchGate()
    lock = threading.Lock()
    state = {"inside": 0, "violations": 0, "launches": 0, "quiesces": 0}
    stop = threading.Event()

    def launcher():
        while not stop.is_set():
            with gate.launching():
                with lock:
                    state["inside"] += 1
                    state["launches"] += 1
                with gate.launching():
                    pass
                with lock:
                    state["inside"] -= 1

    def quiescer():
        for _ in range(200):
            with gate.quiesced():
                with lock:
                    state["violations"] += state["inside"] != 0
                    state["quiesces"] += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=launcher) for _ in range(8)]
        for t in threads:
            t.start()
        q = threading.Thread(target=quiescer)
        q.start()
        q.join(120)
        stop.set()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not q.is_alive() and not any(t.is_alive() for t in threads)
    assert state["quiesces"] == 200 and state["launches"] > 0
    assert state["violations"] == 0


def test_a_capture_holds_engine_searches_off_while_it_starts(setup, tmp_path,
                                                             monkeypatch):
    """While a capture's session starts, a search on another thread waits
    at the gate, then runs once the session is started."""
    import torch.profiler
    from repro_torch.device import LAUNCHES
    corpus, root = setup
    sess = FlashSearchSession(FlashStore.open(root), CFG, "cpu", obs=Obs())
    sess.search(*_query(corpus))               # warm: slabs cached
    srv = sess.start_telemetry(profile_dir=str(tmp_path / "prof"))
    starting, go = threading.Event(), threading.Event()
    real_start = torch.profiler.profile.start

    def slow_start(prof):
        starting.set()
        go.wait(60)
        real_start(prof)

    monkeypatch.setattr(torch.profiler.profile, "start", slow_start)
    done = threading.Event()
    cap = threading.Thread(target=lambda: srv.capture(1))
    cap.start()
    try:
        assert starting.wait(60)                # inside the quiesce
        s = threading.Thread(target=lambda: (sess.search(*_query(corpus)),
                                             done.set()))
        s.start()
        assert not done.wait(0.3)               # held at the gate
    finally:
        go.set()
    assert done.wait(60)
    cap.join(60)
    s.join(60)
    assert not cap.is_alive() and not s.is_alive()
    assert not LAUNCHES._closing and LAUNCHES._inside == 0
    sess.close()
