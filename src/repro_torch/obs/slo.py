"""Declarative SLOs evaluated against the rolling windows
(DESIGN.md §8.4).

An :class:`SLObjective` names a target the serving plane must hold —
"99% of store queries under 250 ms", "99.9% of cluster queries
succeed" — and :class:`SLOMonitor` prices the live system against it
using the §8.4 window twins (burn rate: how fast is the error budget
being spent *right now*) and the lifetime instruments (budget: how much
has been spent since process start):

- **latency** objectives read a latency histogram (``query_ms`` by
  surface, ``cluster_shard_ms`` by shard, ...); the good-event fraction
  is the interpolated mass at or under ``threshold_ms``.
- **availability** objectives read an event counter and its error
  counter (``queries_total`` / ``query_errors_total``); good fraction
  is ``1 - errors/total``.

Each evaluation derives:

- ``good_fraction`` over the rolling window (None with no traffic);
- ``burn_rate`` = (window bad fraction) / (allowed bad fraction) — 1.0
  means the budget is being consumed exactly at the sustainable pace,
  >1 means the window is out of objective;
- ``budget_remaining`` = 1 - (lifetime bad fraction)/(allowed) — the
  cumulative error budget left, clamped to [-inf, 1];
- ``state``: ``ok`` (burn <= 1), ``burning`` (burn > 1 but budget
  left), ``exhausted`` (budget spent). No traffic is ``ok``: an idle
  window burns nothing.

``evaluate()`` also mirrors every status into registry gauges
(``slo_good_fraction`` / ``slo_burn_rate`` / ``slo_budget_remaining`` /
``slo_state`` with 0=ok 1=burning 2=exhausted), so a plain /metrics
scrape carries the SLO plane without calling /slo. This is deliberately
the enabling half of the ROADMAP's tail-latency item: admission control
and shedding act on these burn states.

A copy of ``repro.obs.slo``: the same objectives, the same arithmetic
and the same gauge names, so on the same registry contents and the same
clock ``SLOStatus.to_dict()`` equals the reference's key for key. Numpy
and stdlib only; nothing here touches the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

STATE_OK = "ok"
STATE_BURNING = "burning"
STATE_EXHAUSTED = "exhausted"
_STATE_CODE = {STATE_OK: 0, STATE_BURNING: 1, STATE_EXHAUSTED: 2}


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One declarative objective. ``labels`` selects the instrument
    series (e.g. ``(("surface", "store"),)``); use :func:`latency_slo` /
    :func:`availability_slo` instead of spelling the tuples out."""
    name: str
    kind: str                            # "latency" | "availability"
    metric: str                          # histogram or total-counter name
    labels: Tuple[Tuple[str, str], ...]
    target: float                        # good-event target in (0, 1]
    threshold_ms: float = 0.0            # latency only
    error_metric: str = ""               # availability only

    def __post_init__(self):
        if not 0.0 < self.target <= 1.0:
            raise ValueError(f"target must be in (0, 1], got {self.target}")
        if self.kind not in ("latency", "availability"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")

    @property
    def label_dict(self) -> Dict[str, str]:
        return dict(self.labels)


def latency_slo(name: str, *, threshold_ms: float, target: float = 0.99,
                metric: str = "query_ms", **labels) -> SLObjective:
    """``target`` fraction of ``metric{labels}`` at or under
    ``threshold_ms``."""
    return SLObjective(name=name, kind="latency", metric=metric,
                       labels=tuple(sorted((k, str(v))
                                           for k, v in labels.items())),
                       target=target, threshold_ms=float(threshold_ms))


def availability_slo(name: str, *, target: float = 0.999,
                     metric: str = "queries_total",
                     error_metric: str = "query_errors_total",
                     **labels) -> SLObjective:
    """``target`` fraction of ``metric{labels}`` events without a
    matching ``error_metric{labels}`` error."""
    return SLObjective(name=name, kind="availability", metric=metric,
                       labels=tuple(sorted((k, str(v))
                                           for k, v in labels.items())),
                       target=target, error_metric=error_metric)


def default_slos(surface: str, *, latency_ms: float = 250.0,
                 latency_target: float = 0.99,
                 availability_target: float = 0.999) -> List[SLObjective]:
    """The stock per-surface pair every serving target starts with."""
    return [
        latency_slo(f"{surface}-latency", threshold_ms=latency_ms,
                    target=latency_target, surface=surface),
        availability_slo(f"{surface}-availability",
                         target=availability_target, surface=surface),
    ]


@dataclasses.dataclass
class SLOStatus:
    """One evaluation of one objective (JSON-friendly via ``to_dict``)."""
    name: str
    kind: str
    target: float
    state: str
    good_fraction: Optional[float]       # rolling window; None = idle
    burn_rate: float
    budget_remaining: float
    window_events: int
    lifetime_events: int
    detail: str = ""

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        for k in ("good_fraction", "burn_rate", "budget_remaining"):
            if d[k] is not None:
                d[k] = round(d[k], 6)
        return d


class SLOMonitor:
    """Evaluates objectives against an ``Obs`` bundle's registry.

    Stateless between evaluations — both the window and the lifetime
    numbers live in the instruments themselves, so any number of
    monitors (or scrapes) agree."""

    def __init__(self, obs, objectives: List[SLObjective]):
        self.obs = obs
        self.objectives = list(objectives)

    def add(self, objective: SLObjective) -> None:
        self.objectives.append(objective)

    # -- per-kind good/total extraction --------------------------------
    def _latency(self, o: SLObjective):
        reg = self.obs.registry
        hist = reg.histogram(o.metric, **o.label_dict)
        w = reg.windowed(o.metric, **o.label_dict)
        life_st = hist.state()
        life = (life_st.total,
                hist.fraction_le(o.threshold_ms) if life_st.total else None)
        if w is None:
            return (0, None), life
        wst = w.state()
        win = (wst.total,
               w.fraction_le(o.threshold_ms) if wst.total else None)
        return win, life

    def _availability(self, o: SLObjective):
        reg = self.obs.registry
        total_c = reg.counter(o.metric, **o.label_dict)
        err_c = reg.counter(o.error_metric, **o.label_dict)
        lt, le = total_c.value, err_c.value
        life = (lt, (1.0 - min(le, lt) / lt) if lt else None)
        wt_c = reg.windowed(o.metric, **o.label_dict)
        we_c = reg.windowed(o.error_metric, **o.label_dict)
        if wt_c is None:
            return (0, None), life
        wt = wt_c.total()
        we = we_c.total() if we_c is not None else 0
        win = (wt, (1.0 - min(we, wt) / wt) if wt else None)
        return win, life

    # -- evaluation ----------------------------------------------------
    def evaluate(self) -> List[SLOStatus]:
        out = []
        for o in self.objectives:
            (w_n, w_good), (l_n, l_good) = (
                self._latency(o) if o.kind == "latency"
                else self._availability(o))
            allowed = 1.0 - o.target           # tolerable bad fraction
            burn = 0.0
            if w_good is not None:
                bad = 1.0 - w_good
                burn = (bad / allowed) if allowed > 0 else (
                    float("inf") if bad > 0 else 0.0)
            remaining = 1.0
            if l_good is not None:
                l_bad = 1.0 - l_good
                remaining = (1.0 - l_bad / allowed) if allowed > 0 else (
                    1.0 if l_bad == 0 else float("-inf"))
            if remaining <= 0.0:
                state = STATE_EXHAUSTED
            elif burn > 1.0:
                state = STATE_BURNING
            else:
                state = STATE_OK
            detail = (f"{o.metric} p<= {o.threshold_ms:g}ms"
                      if o.kind == "latency"
                      else f"{o.error_metric}/{o.metric}")
            st = SLOStatus(name=o.name, kind=o.kind, target=o.target,
                           state=state, good_fraction=w_good,
                           burn_rate=burn, budget_remaining=remaining,
                           window_events=w_n, lifetime_events=l_n,
                           detail=detail)
            self._publish(st)
            out.append(st)
        return out

    def _publish(self, st: SLOStatus) -> None:
        reg = self.obs.registry
        if st.good_fraction is not None:
            reg.gauge("slo_good_fraction", slo=st.name).set(st.good_fraction)
        reg.gauge("slo_burn_rate", slo=st.name).set(
            st.burn_rate if st.burn_rate != float("inf") else 1e9)
        reg.gauge("slo_budget_remaining", slo=st.name).set(
            max(st.budget_remaining, -1e9))
        reg.gauge("slo_state", slo=st.name).set(_STATE_CODE[st.state])
