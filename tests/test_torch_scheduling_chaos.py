"""The chaos leg (DESIGN.md §7.3) of ``tests/test_scheduling_chaos.py``
on the port's 2 x 2 cluster, against the JAX package's, on the CPU.

A straggling replica is a session whose searches wait on a
``threading.Event`` that opens only after the call under test has
returned, so hedging must win and a partial gather must miss the
straggler however slow the machine. The SLO is evaluated on an injected
clock (the registry's window clock): no test asserts a duration
(ROADMAP C9); the reference's 0.5 s sleep and 400 ms budget are not
copied. Both cases run once a package on one cluster directory, and the
two packages' observations must be equal."""
import threading

import numpy as np
import pytest
import torch

from repro import cluster as j_cluster
from repro import serve as j_serve
from repro.configs.paper_search import smoke as j_smoke
from repro.core import corpus as j_corpus
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Obs as JObs
from repro.obs import slo as j_slo
from repro.storage.store import _corpus_docs
from repro_torch import cluster as t_cluster
from repro_torch import serve as t_serve
from repro_torch.configs.paper_search import smoke
from repro_torch.obs import MetricsRegistry, Obs
from repro_torch.obs import slo as t_slo
from repro_torch.storage import FlashSearchSession, FlashStore
from tests.test_obs_window import FakeClock

torch.set_num_threads(2)
CFG = smoke()
CORPUS = j_corpus.synthesize(160, CFG.vocab_size, CFG.avg_nnz_per_doc,
                             CFG.nnz_pad, seed=17)
SLO_MS = 400.0          # the reference's budget, as the latency objective
WINDOW_S = 60.0


class _Held:
    """A shard replica's session whose searches wait for ``gate`` first:
    the injected straggler."""

    def __init__(self, inner, gate):
        self._inner = inner
        self._gate = gate

    def search(self, *a, **k):
        self._gate.wait()
        return self._inner.search(*a, **k)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch-chaos")
    docs = _corpus_docs(CORPUS)
    root = str(tmp / "c2x2")
    j_cluster.build_sharded_store(root, docs, n_shards=2, replicas=2,
                                  policy="hash", vocab_size=CFG.vocab_size,
                                  docs_per_segment=16)
    union = FlashStore.create(str(tmp / "u"), vocab_size=CFG.vocab_size,
                              docs_per_segment=64)
    union.append_docs(docs)
    ref = FlashSearchSession(union, CFG, device="cpu", backend="torch")
    yield root, ref
    ref.close()


def _packages():
    """(port, cluster module, serve module, slo module, Obs, registry,
    session kwargs) for the reference, then the port."""
    return [(False, j_cluster, j_serve, j_slo, JObs, JRegistry,
             {"cfg": j_smoke()}),
            (True, t_cluster, t_serve, t_slo, Obs, MetricsRegistry,
             {"cfg": CFG, "device": "cpu", "backend": "torch"})]


def _each(root, scenario, hedge=True):
    """``scenario(sess, serve, clock, monitor)`` once a package: a session
    on an injected-clock registry, every replica opened and warm through
    direct shard-session calls (which never reach the router's
    ``cluster_shard_ms`` window), then three router queries to seed the
    window the hedge timer reads. Returns the two observations, which
    must be equal."""
    out = []
    for port, cl, serve, slo, obs_cls, reg_cls, kw in _packages():
        clock = FakeClock(1000.0)
        obs = obs_cls(registry=reg_cls(window_s=WINDOW_S, clock=clock))
        policy = (serve.HedgePolicy(percentile=0.95, min_ms=1.0,
                                    fallback_ms=30.0) if hedge else None)
        sess = cl.FlashClusterSession(root, kw.pop("cfg"), obs=obs,
                                      hedge_policy=policy, **kw)
        monitor = slo.SLOMonitor(obs, [
            slo.latency_slo("cluster-latency", threshold_ms=SLO_MS,
                            surface="cluster"),
            slo.availability_slo("cluster-availability",
                                 surface="cluster")])
        try:
            wi, wv = j_corpus.make_query(CORPUS, 0, CFG.max_query_nnz)
            wq = serve.Query(wi[None], wv[None])
            for s in range(2):
                for r in range(2):
                    sess.router._session(s, r).search_typed(wq)
            for _ in range(3):
                sess.search_typed(wq)
            out.append(scenario(sess, serve, clock, monitor))
        finally:
            sess.router._hedge_executor().shutdown(wait=True)
            sess.close()
    assert out[0] == out[1]
    return out[1]


def _rows(res):
    return (np.asarray(res.doc_ids).tolist(),
            np.asarray(res.scores).view(np.uint32).tolist())


def _slo(monitor):
    """Each objective's window and lifetime event counts, and the
    availability objective's state and good fraction. The latency
    objective's state is left out: its events are wall-clock query
    times, which only the card's run may be held to."""
    lat, avail = monitor.evaluate()
    return (lat.window_events, lat.lifetime_events, avail.state,
            avail.good_fraction, avail.window_events, avail.burn_rate)


def test_chaos_hedging_keeps_slo_green_and_complete(cluster):
    """With shard 1's primary held until each call returns, hedging wins
    the race: every query gets a FULL (partial=False) answer equal to the
    union store's, the availability objective stays green on the
    injected clock, and the held replica is slow, not dead."""
    root, union = cluster
    qs = [j_corpus.make_query(CORPUS, i, CFG.max_query_nnz)
          for i in (3, 41, 77)]
    want = [_rows(union.search_typed(t_serve.Query(qi[None], qv[None])))
            for qi, qv in qs]

    def scenario(sess, serve, clock, monitor):
        seen = []
        for qi, qv in qs:
            gate = threading.Event()
            inner = sess.router._sessions[1][0]
            sess.router._sessions[1][0] = _Held(inner, gate)
            try:
                resp = sess.search(serve.Query(qi[None], qv[None]),
                                   options=serve.QueryOptions(
                                       deadline_ms=60_000.0,
                                       allow_partial=True))
            finally:
                gate.set()
                sess.router._sessions[1][0] = inner
            seen.append((_rows(resp.results), resp.stats.partial,
                         resp.stats.shards_missing, resp.stats.hedged))
        st = sess.last_stats
        green = _slo(monitor)
        clock.advance(2 * WINDOW_S)            # the window empties...
        idle = _slo(monitor)
        return (seen, st.hedges >= 1, st.hedge_wins >= 1,
                sess.router.health(), green, idle)

    seen, hedged, won, health, green, idle = _each(root, scenario)
    for (rows, partial, missing, was_hedged), expect in zip(seen, want):
        assert rows == expect
        assert not partial and missing == () and was_hedged
    assert hedged and won
    assert health == [[True, True], [True, True]]    # slow, not dead
    # 3 warm-up + 3 hedged queries, none an error
    assert green == (6, 6, "ok", 1.0, 6, 0.0)
    # ...while the lifetime budget keeps every event
    assert idle == (0, 6, "ok", None, 0, 0.0)


def test_chaos_partial_gather_caps_damage_without_hedging(cluster):
    """The same straggler with hedging pinned off and its sibling out of
    rotation: the deadline-bound gather returns shard 0's answer flagged
    partial, and a partial answer is no availability error."""
    root, _ = cluster
    qi, qv = j_corpus.make_query(CORPUS, 19, CFG.max_query_nnz)

    def scenario(sess, serve, clock, monitor):
        q = serve.Query(qi[None], qv[None])
        sess.search_typed(q)
        gate = threading.Event()
        inner = sess.router._sessions[1][0]
        sess.router._sessions[1][0] = _Held(inner, gate)
        sess.router.mark_down(1, 1)            # no fail-over, no hedge
        try:
            resp = sess.search(q, options=serve.QueryOptions(
                deadline_ms=1000.0, allow_partial=True, hedging=False))
        finally:
            gate.set()
        sess.router._sessions[1][0] = inner
        sess.router.reset_health()
        shard0 = sess.router._session(0, 0).search_typed(q)
        reg = sess.obs.registry
        return (_rows(resp.results), _rows(shard0), resp.stats.partial,
                resp.stats.shards_missing, resp.stats.hedged,
                reg.counter("cluster_partial_total").value, _slo(monitor))

    got, shard0, partial, missing, hedged, n_partial, slo = _each(
        root, scenario, hedge=False)
    assert got == shard0 and (np.asarray(got[0]) >= 0).any()
    assert partial and missing == (1,) and not hedged and n_partial == 1
    assert slo == (5, 5, "ok", 1.0, 5, 0.0)
