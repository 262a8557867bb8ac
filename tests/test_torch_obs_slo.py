"""The port's SLO objectives and burn-state accounting
(``repro_torch.obs.slo``) against the JAX package's, on the CPU.

The seven cases of ``tests/test_obs_slo.py``: each step feeds both
packages' registries the same observations on one injected clock, and
every ``SLOStatus.to_dict()`` and every published gauge (the registries'
Prometheus text) must be equal, beside the reference test's own
assertions on the port's numbers."""
import pytest

from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Obs as JObs
from repro.obs import slo as j_slo
from repro_torch.obs import MetricsRegistry, Obs
from repro_torch.obs import slo as t_slo
from repro_torch.obs.slo import (STATE_BURNING, STATE_EXHAUSTED, STATE_OK,
                                 SLObjective, availability_slo, default_slos,
                                 latency_slo)
from tests.test_obs_window import FakeClock


class Twin:
    """One registry a package on one clock; every step lands in both."""

    def __init__(self, objectives, window_s=10.0, slices=5):
        self.clock = FakeClock()
        self.obs = {}
        self.mon = {}
        for key, obs_cls, reg_cls, mod in (
                ("ref", JObs, JRegistry, j_slo),
                ("port", Obs, MetricsRegistry, t_slo)):
            self.obs[key] = obs_cls(registry=reg_cls(
                window_s=window_s, window_slices=slices, clock=self.clock))
            self.mon[key] = mod.SLOMonitor(
                self.obs[key], [_as(mod, o) for o in objectives])

    def observe(self, v, n=1, metric="query_ms", **labels):
        for obs in self.obs.values():
            h = obs.registry.histogram(metric, **labels)
            for _ in range(n):
                h.observe(v)

    def inc(self, metric, n, **labels):
        for obs in self.obs.values():
            obs.registry.counter(metric, **labels).inc(n)

    def evaluate(self):
        """The port's statuses, after holding them and the gauges they
        publish to the reference's."""
        ref, port = self.mon["ref"].evaluate(), self.mon["port"].evaluate()
        assert [s.to_dict() for s in port] == [s.to_dict() for s in ref]
        assert self.registry.to_prometheus(include_windows=True) == \
            self.obs["ref"].registry.to_prometheus(include_windows=True)
        return port

    @property
    def registry(self):
        return self.obs["port"].registry


def _as(mod, o):
    """The port's objective as ``mod``'s own dataclass."""
    return mod.SLObjective(**{f: getattr(o, f) for f in (
        "name", "kind", "metric", "labels", "target", "threshold_ms",
        "error_metric")})


# -- objective declaration ---------------------------------------------

def test_builders_and_validation():
    o = latency_slo("store-latency", threshold_ms=250.0, target=0.99,
                    surface="store")
    assert o.kind == "latency" and o.threshold_ms == 250.0
    assert o.label_dict == {"surface": "store"}
    a = availability_slo("cluster-avail", target=0.999, surface="cluster")
    assert a.error_metric == "query_errors_total"
    for bad in (0.0, 1.5):
        for mod in (j_slo, t_slo):
            with pytest.raises(ValueError):
                mod.latency_slo("bad", threshold_ms=10.0, target=bad)
    for mod in (j_slo, t_slo):
        with pytest.raises(ValueError):
            mod.SLObjective(name="x", kind="nonsense", metric="m",
                            labels=(), target=0.9)
    stock = default_slos("store", latency_ms=100.0)
    assert [s.kind for s in stock] == ["latency", "availability"]
    assert [_as(j_slo, s) for s in stock] == j_slo.default_slos(
        "store", latency_ms=100.0)
    assert _as(j_slo, o) == j_slo.latency_slo(
        "store-latency", threshold_ms=250.0, target=0.99, surface="store")
    assert _as(j_slo, a) == j_slo.availability_slo(
        "cluster-avail", target=0.999, surface="cluster")


def test_no_traffic_is_ok():
    tw = Twin(default_slos("store"))
    for st in tw.evaluate():
        assert st.state == STATE_OK
        assert st.good_fraction is None
        assert st.burn_rate == 0.0
        assert st.window_events == 0


# -- the latency-step transition ---------------------------------------

def test_latency_step_ok_to_burning_to_recovered():
    tw = Twin([latency_slo("store-latency", threshold_ms=100.0,
                           target=0.90, surface="store")])
    tw.observe(10.0, 1000, surface="store")   # healthy: under threshold
    (st,) = tw.evaluate()
    assert st.state == STATE_OK
    assert st.good_fraction == pytest.approx(1.0)

    tw.clock.advance(20.0)        # healthy burst ages out of the window
    tw.observe(10.0, 170, surface="store")    # the step: 15% slow
    tw.observe(5000.0, 30, surface="store")
    (st,) = tw.evaluate()
    assert st.state == STATE_BURNING
    assert st.window_events == 200
    assert st.burn_rate == pytest.approx(0.15 / 0.10, rel=1e-6)
    assert st.budget_remaining == pytest.approx(0.75, rel=1e-6)

    tw.clock.advance(50.0)        # the step ages out of the window...
    tw.observe(10.0, 100, surface="store")
    (st,) = tw.evaluate()
    assert st.state == STATE_OK   # ...and the burn state recovers
    assert st.good_fraction == pytest.approx(1.0)
    assert st.budget_remaining < 1.0          # the budget stays spent


def test_sustained_burn_exhausts_budget_and_stays_exhausted():
    tw = Twin([latency_slo("tight", threshold_ms=1.0, target=0.99,
                           surface="store")])
    tw.observe(500.0, 100, surface="store")   # every event bad
    (st,) = tw.evaluate()
    assert st.state == STATE_EXHAUSTED
    assert st.budget_remaining <= 0.0
    tw.clock.advance(100.0)       # idle window: burn 0, budget still gone
    (st,) = tw.evaluate()
    assert st.state == STATE_EXHAUSTED
    assert st.burn_rate == 0.0


def test_target_one_edge():
    tw = Twin([latency_slo("perfect", threshold_ms=100.0, target=1.0,
                           surface="store")])
    tw.observe(1.0, surface="store")
    (st,) = tw.evaluate()
    assert st.state == STATE_OK
    tw.observe(5000.0, surface="store")
    (st,) = tw.evaluate()
    assert st.state == STATE_EXHAUSTED


# -- availability ------------------------------------------------------

def test_availability_counts_errors():
    tw = Twin([availability_slo("cluster-avail", target=0.90,
                                surface="cluster")])
    tw.inc("queries_total", 100, surface="cluster")
    tw.inc("query_errors_total", 0, surface="cluster")
    (st,) = tw.evaluate()
    assert st.state == STATE_OK and st.good_fraction == pytest.approx(1.0)
    tw.inc("query_errors_total", 50, surface="cluster")   # 50% vs 10%
    (st,) = tw.evaluate()
    assert st.state in (STATE_BURNING, STATE_EXHAUSTED)
    assert st.good_fraction == pytest.approx(0.5)
    assert st.burn_rate == pytest.approx(5.0)
    tw.clock.advance(100.0)       # errors age out of the window
    tw.inc("queries_total", 100, surface="cluster")
    (st,) = tw.evaluate()
    assert st.good_fraction == pytest.approx(1.0)
    assert st.burn_rate == 0.0


# -- gauge publication -------------------------------------------------

def test_evaluate_publishes_gauges_and_dict():
    tw = Twin([latency_slo("store-latency", threshold_ms=100.0,
                           target=0.90, surface="store")])
    tw.observe(5000.0, 10, surface="store")
    (st,) = tw.evaluate()
    reg = tw.registry
    assert reg.gauge("slo_state", slo="store-latency").value == 2.0
    assert reg.gauge("slo_burn_rate", slo="store-latency").value >= 1.0
    assert reg.gauge("slo_good_fraction",
                     slo="store-latency").value == pytest.approx(0.0)
    d = st.to_dict()
    assert d["name"] == "store-latency" and d["state"] == STATE_EXHAUSTED
    assert set(d) >= {"kind", "target", "good_fraction", "burn_rate",
                      "budget_remaining", "window_events",
                      "lifetime_events", "detail"}
    text = reg.to_prometheus()
    assert 'repro_slo_state{slo="store-latency"} 2' in text
    assert text == tw.obs["ref"].registry.to_prometheus()
