"""The port's replica hedging (``serve/hedging.py``) and the router's
deadline-bound partial gather against the JAX package's, on the CPU.

No test races the wall clock or asserts a duration (ROADMAP C9). A
straggling replica is a session wrapped to block on a
``threading.Event`` that opens only after the call under test has
returned, so the hedge must win and the straggler must be missing from
a partial gather, however slow the machine. ``run_hedged``'s attempts
block on events too. ``HedgePolicy`` is held to the reference's on the
same observations; the partial-gather scenarios run in both packages on
one cluster directory with equal ``ClusterStats`` and ``QueryStats``
fields."""
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro import cluster as j_cluster
from repro import serve as j_serve
from repro.configs.paper_search import smoke as j_smoke
from repro.core import corpus as j_corpus
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Obs as JObs
from repro.storage.store import _corpus_docs
from repro_torch import cluster as t_cluster
from repro_torch import serve as t_serve
from repro_torch.configs.paper_search import smoke
from repro_torch.obs import MetricsRegistry, Obs

torch.set_num_threads(2)
CFG = smoke()
CORPUS = j_corpus.synthesize(150, CFG.vocab_size, CFG.avg_nnz_per_doc,
                             CFG.nnz_pad, seed=13)
DOCS = _corpus_docs(CORPUS)
PKGS = [(j_serve, JRegistry), (t_serve, MetricsRegistry)]


@pytest.fixture(scope="module")
def pool():
    with ThreadPoolExecutor(max_workers=4) as ex:
        yield ex


def _each(scenario):
    """``scenario(serve_module, registry_cls)`` in both packages; the two
    observations must be equal. Returns the port's."""
    ref, port = (scenario(*pkg) for pkg in PKGS)
    assert port == ref
    return port


def _gated(gate, value):
    def attempt():
        gate.wait()
        return value
    return attempt


def _raises(exc):
    def attempt():
        raise exc
    return attempt


# ---------------------------------------------------------------------------
# run_hedged, on events
# ---------------------------------------------------------------------------
def test_a_primary_that_returns_never_fires_a_hedge(pool):
    def scenario(serve, _):
        out = serve.run_hedged([lambda: "fast", lambda: "never"], pool,
                               hedge_after_s=60.0)
        return out.result, out.winner_index, out.hedges_fired, out.hedge_won

    assert _each(scenario) == ("fast", 0, 0, False)


def test_a_hedge_fires_and_wins_on_a_gated_primary(pool):
    def scenario(serve, _):
        gate, fired = threading.Event(), []
        out = serve.run_hedged([_gated(gate, "slow"), lambda: "hedge"],
                               pool, hedge_after_s=0.0,
                               on_hedge=fired.append)
        gate.set()
        return (out.result, out.winner_index, out.hedges_fired,
                out.hedge_won, fired)

    assert _each(scenario) == ("hedge", 1, 1, True, [1])


def test_a_hedge_fires_but_loses_to_the_primary(pool):
    """The primary returns once the hedge has started; the hedge is held
    until the call has returned: fired, not won."""
    def scenario(serve, _):
        entered, gate = threading.Event(), threading.Event()

        def primary():
            entered.wait()              # the hedge has started
            return "primary"

        def laggard():
            entered.set()
            gate.wait()
            return "laggard"

        out = serve.run_hedged([primary, laggard], pool, hedge_after_s=0.0)
        gate.set()
        return out.result, out.hedges_fired, out.hedge_won

    assert _each(scenario) == ("primary", 1, False)


def test_an_error_fires_the_next_attempt_at_once(pool):
    """A 1-hour timer: only the primary's error can launch the backup."""
    def scenario(serve, _):
        out = serve.run_hedged([_raises(OSError("replica gone")),
                                lambda: "backup"], pool,
                               hedge_after_s=3600.0)
        return (out.result, out.hedge_won, out.hedges_fired,
                type(out.errors[0]).__name__, out.errors[1])

    assert _each(scenario) == ("backup", True, 1, "OSError", None)


def test_every_attempt_failed_raises_the_first_error(pool):
    def scenario(serve, _):
        with pytest.raises(OSError, match="a"):
            serve.run_hedged([_raises(OSError("a")), _raises(ValueError("b"))],
                             pool, hedge_after_s=0.0)
        return True

    _each(scenario)


def test_one_attempt_is_a_plain_call_and_none_is_refused(pool):
    def scenario(serve, _):
        r = serve.run_hedged([lambda: 7], pool, hedge_after_s=0.0).result
        with pytest.raises(ValueError):
            serve.run_hedged([], pool, hedge_after_s=0.0)
        return r

    assert _each(scenario) == 7


def test_hedges_never_queue_behind_an_abandoned_loser():
    """Two hedged calls against one gated straggler that holds its
    replica's lock (as the router's per-replica locks do): the second
    call's primary waits on that lock, so only its hedge can answer, and
    it must start at once on ``SpawnExecutor``; ``shutdown`` joins the
    stragglers once the gate opens."""
    def scenario(serve, _):
        ex, gate, replica0 = serve.SpawnExecutor(), threading.Event(), \
            threading.Lock()

        def slow():
            with replica0:
                gate.wait()
                return "slow"

        outs = [serve.run_hedged([slow, lambda: "fast"], ex,
                                 hedge_after_s=0.0) for _ in range(2)]
        gate.set()
        ex.shutdown(wait=True)
        return [(o.result, o.hedge_won) for o in outs], len(ex._threads)

    assert _each(scenario) == ([("fast", True)] * 2, 0)


def test_a_cancel_flag_is_set_once():
    flags = [serve.hedging.CancelFlag() for serve, _ in PKGS]
    for f in flags:
        assert not f
        f.set()
        f.set()
        assert f


# ---------------------------------------------------------------------------
# HedgePolicy on the same observations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("observations,policy", [
    ((10.0,) * 19 + (200.0,), dict(percentile=0.5, min_ms=1.0,
                                   fallback_ms=999.0)),
    ((10.0,) * 19 + (200.0,), dict(percentile=0.95)),
    ((0.01,) * 50, dict(min_ms=5.0)),
    ((), dict(percentile=0.95, min_ms=5.0, fallback_ms=42.0)),
    ((3.0, 7.0, 40.0, 2.5), dict(percentile=0.75, min_ms=0.0,
                                 fallback_ms=1.0))])
def test_hedge_policy_reads_the_window_as_the_reference_does(observations,
                                                             policy):
    def scenario(serve, registry):
        reg = registry()
        h = reg.histogram("cluster_shard_ms")
        for ms in observations:
            h.observe(ms)
        pol = serve.HedgePolicy(**policy)
        return pol.hedge_after_ms(reg), pol.hedge_after_ms(None)

    thr, cold = _each(scenario)
    assert cold == max(policy.get("min_ms", 1.0),
                       policy.get("fallback_ms", 50.0))
    if not observations:
        assert thr == cold


@pytest.mark.parametrize("bad", [dict(percentile=1.5), dict(percentile=0.0),
                                 dict(fallback_ms=0.0), dict(min_ms=-1.0)])
def test_hedge_policy_validates(bad):
    for serve, _ in PKGS:
        with pytest.raises(ValueError):
            serve.HedgePolicy(**bad)


# ---------------------------------------------------------------------------
# the router: a gated replica
# ---------------------------------------------------------------------------
class _Gated:
    """A replica session whose searches wait for ``gate`` first. It
    records the thread each search ran on and counts the ones that
    finished."""

    def __init__(self, inner, gate):
        self._inner = inner
        self._gate = gate
        self.threads = []
        self.finished = 0

    def search(self, *a, **k):
        self.threads.append(threading.current_thread().name)
        self._gate.wait()
        out = self._inner.search(*a, **k)
        self.finished += 1
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _Boom:
    def __init__(self, inner):
        self._inner = inner

    def search(self, *a, **k):
        raise OSError("replica storage gone")

    def close(self):
        if self._inner is not None:
            self._inner.close()

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """2-shard clusters of 1 and 2 replicas, written by the reference,
    and a union store."""
    tmp = tmp_path_factory.mktemp("torch-hedging")
    out = {}
    for replicas in (1, 2):
        out[replicas] = str(tmp / f"c{replicas}")
        j_cluster.build_sharded_store(out[replicas], DOCS, n_shards=2,
                                      replicas=replicas, policy="hash",
                                      vocab_size=CFG.vocab_size,
                                      docs_per_segment=16)
    return out


def _session(port, root, **kw):
    if port:
        return t_cluster.FlashClusterSession(root, CFG, device="cpu",
                                             backend="torch", **kw)
    return j_cluster.FlashClusterSession(root, j_smoke(), **kw)


def _query(port, idx):
    qi, qv = j_corpus.make_query(CORPUS, idx, CFG.max_query_nnz)
    serve = t_serve if port else j_serve
    return serve, serve.Query(qi[None], qv[None])


def _result(res):
    return (np.asarray(res.doc_ids).tolist(),
            np.asarray(res.scores).view(np.uint32).tolist())


def _both(scenario, root, policy=None, **kw):
    """``scenario(port, session)`` once a package on one directory; the
    session is closed after the scenario's gates are open. ``policy``
    (``HedgePolicy`` fields) arms each package's own router policy.
    Returns the reference's and the port's observations."""
    out = []
    for port in (False, True):
        if policy is not None:
            serve = t_serve if port else j_serve
            kw["hedge_policy"] = serve.HedgePolicy(**policy)
        sess = _session(port, root, **kw)
        try:
            out.append(scenario(port, sess))
        finally:
            sess.close()
    return out


def _gate_primary(sess, shard):
    gate = threading.Event()
    gated = _Gated(sess.router._session(shard, 0), gate)
    sess.router._sessions[shard][0] = gated
    return gate, gated


@pytest.mark.parametrize("shard", [0, 1])
def test_the_hedge_outruns_a_gated_primary_bit_identically(roots, shard):
    def scenario(port, sess):
        serve, q = _query(port, 7)
        full = sess.search_typed(q)            # every primary open
        gate, gated = _gate_primary(sess, shard)
        try:
            res = sess.search_typed(q)
            st = sess.last_stats
            seen = (_result(res) == _result(full), st.hedges >= 1,
                    st.hedge_wins >= 1, st.partial, st.shards_missing,
                    sess.router.health(), st.failovers)
        finally:
            gate.set()
        sess.router._hedge_executor().shutdown(wait=True)
        return seen + (gated.finished, gated.threads)

    out = _both(scenario, roots[2],
                policy=dict(fallback_ms=1.0, min_ms=0.0))
    assert out[0] == out[1]
    same, hedged, won, partial, missing, health, failovers, finished, \
        threads = out[1]
    assert same and hedged and won and not partial and missing == ()
    # slow is not failed: the straggler stays in rotation
    assert health == [[True, True], [True, True]] and failovers == 0
    # the loser ran to its end once the gate opened, on a hedge thread
    assert finished == 1 and threads == ["hedge-attempt"]


def test_a_per_query_opt_out_pins_hedging_off(roots):
    """With the router's policy armed, ``hedging=False`` runs the primary
    on the shard pool's own thread, with no hedge machinery; the same
    query without the opt-out runs it as a hedged attempt."""
    def scenario(port, sess):
        serve, q = _query(port, 3)
        full = sess.search_typed(q)
        gate, gated = _gate_primary(sess, 0)
        gate.set()                             # never holds: no race
        off = sess.search_typed(q, options=serve.QueryOptions(hedging=False))
        st = sess.last_stats
        on = sess.search_typed(q)
        return (_result(off) == _result(full) == _result(on), st.hedges,
                [t.split("_")[0] for t in gated.threads])

    out = _both(scenario, roots[2], policy=dict(fallback_ms=1.0))
    assert out[0] == out[1] == (True, 0, ["shard-router", "hedge-attempt"])


def test_a_per_query_opt_in_arms_hedging_without_a_router_policy(roots):
    def scenario(port, sess):
        serve, q = _query(port, 5)
        assert sess.router.hedge_policy is None
        full = sess.search_typed(q)
        gate, gated = _gate_primary(sess, 1)
        try:
            res = sess.search_typed(q, options=serve.QueryOptions(
                hedging=True))
            st = sess.last_stats
        finally:
            gate.set()
        reg = sess.obs.registry
        return (_result(res) == _result(full), st.hedges >= 1,
                st.hedge_wins >= 1,
                reg.counter("cluster_hedges_total").value >= 1,
                reg.counter("cluster_hedge_wins_total").value >= 1)

    out = []
    for port in (False, True):
        obs = Obs(registry=MetricsRegistry()) if port else JObs(
            registry=JRegistry())
        sess = _session(port, roots[2], obs=obs)
        try:
            out.append(scenario(port, sess))
        finally:
            sess.close()
    assert out[0] == out[1] == (True,) * 5


# ---------------------------------------------------------------------------
# the partial gather: a gated shard, port against reference
# ---------------------------------------------------------------------------
def _query_stats(qs):
    return dataclasses.asdict(qs)


def _cluster_stats(st):
    return (st.partial, st.shards_missing, st.hedges, st.hedge_wins,
            st.failovers, [s is None for s in st.per_shard],
            st.segments_scored, st.docs_scored)


def test_the_partial_gather_drops_a_gated_shard_and_flags_it(roots):
    """Shard 1's primary is gated until the call has returned, so it
    misses any deadline; shard 0 answers well inside a 1 s budget."""
    def scenario(port, sess):
        serve, q = _query(port, 9)
        sess.search_typed(q)                   # warm: every primary open
        gate, gated = _gate_primary(sess, 1)
        try:
            resp = sess.search(q, options=serve.QueryOptions(
                deadline_ms=1000.0, allow_partial=True))
            st = sess.last_stats
        finally:
            gate.set()
        shard0 = sess.router._session(0, 0).search_typed(q)
        return (_result(resp), _result(shard0), _query_stats(resp.stats),
                _cluster_stats(st))

    ref, port = _both(scenario, roots[1])
    assert port == ref
    got, shard0, qstats, cstats = port
    assert got == shard0 and (np.asarray(got[0]) >= 0).any()
    assert qstats["partial"] and qstats["shards_missing"] == (1,)
    assert cstats[:2] == (True, (1,)) and cstats[5] == [False, True]


def test_the_partial_gather_equals_the_full_one_when_all_answer(roots):
    def scenario(port, sess):
        serve, q = _query(port, 4)
        plain = sess.search_typed(q)
        resp = sess.search(q, options=serve.QueryOptions(
            deadline_ms=60_000.0, allow_partial=True))
        return (_result(resp), _result(plain), _query_stats(resp.stats),
                _cluster_stats(sess.last_stats))

    ref, port = _both(scenario, roots[1])
    assert port == ref
    got, plain, qstats, cstats = port
    assert got == plain and not qstats["partial"] and cstats[1] == ()


def test_every_shard_missing_returns_the_sentinel(roots):
    def scenario(port, sess):
        serve, q = _query(port, 9)
        sess.search_typed(q)
        gates = [_gate_primary(sess, s)[0] for s in range(2)]
        try:
            resp = sess.search(q, options=serve.QueryOptions(
                deadline_ms=40.0, allow_partial=True))
            st = sess.last_stats
        finally:
            for g in gates:
                g.set()
        return _result(resp), _query_stats(resp.stats), _cluster_stats(st)

    ref, port = _both(scenario, roots[1])
    assert port == ref
    (ids, scores), qstats, cstats = port
    assert (np.asarray(ids) == -1).all() and np.asarray(ids).shape == (
        1, CFG.top_k)
    assert np.isneginf(np.asarray(scores, np.uint32).view(np.float32)).all()
    assert qstats["shards_missing"] == (0, 1)


def test_consent_turns_a_failed_shard_into_a_missing_one(roots):
    def scenario(port, sess):
        serve, q = _query(port, 9)
        sess.search_typed(q)
        sess.router._sessions[0][0] = _Boom(sess.router._sessions[0][0])
        resp = sess.search(q, options=serve.QueryOptions(
            deadline_ms=60_000.0, allow_partial=True))
        cl = t_cluster if port else j_cluster
        with pytest.raises(cl.ClusterSearchError):
            sess.search_typed(q)               # without consent: raises
        return _result(resp), _query_stats(resp.stats)

    ref, port = _both(scenario, roots[1])
    assert port == ref
    assert port[1]["partial"] and port[1]["shards_missing"] == (0,)


def test_a_failure_without_consent_raises_a_structured_error(roots):
    def scenario(port, sess):
        serve, q = _query(port, 9)
        sess.search_typed(q)
        for r in range(2):
            sess.router._sessions[1][r] = _Boom(sess.router._sessions[1][r])
        cl = t_cluster if port else j_cluster
        with pytest.raises(cl.ClusterSearchError) as ei:
            sess.search_typed(q)
        e = ei.value
        return (e.shard, sorted(e.replica_errors),
                all("OSError" in s for s in e.replica_errors.values()),
                e.trace_id, "shard 1" in str(e))

    ref, port = _both(scenario, roots[2])
    assert port == ref == (1, [0, 1], True, None, True)


def test_cluster_stats_scheduling_fields_default_off():
    for cl in (j_cluster, t_cluster):
        st = cl.ClusterStats([None])
        assert not st.partial and st.shards_missing == ()
        assert st.hedges == 0 and st.hedge_wins == 0
        assert st.skip_rate == 0.0 and st.cache_hit_rate == 0.0
