"""Typed request/response surface of the serving tier (DESIGN.md §7.3).

A copy of ``repro.serve.api``:

    ``Query``          the sparse pattern itself (ids/vals, 1-D single
                       or 2-D batch), validated once at the boundary
    ``QueryOptions``   how the request may be scheduled: deadline_ms,
                       priority, tenant, k, allow_partial, hedging
    ``QueryStats``     what scheduling did to it
    ``SearchResponse`` results + QueryStats; quacks like SearchResult
                       (``.doc_ids`` / ``.scores``)

The positional ``search(q_ids, q_vals)`` form still works but is a
deprecation shim: ``coerce_request`` emits the ``DeprecationWarning``.
Surfaces return a ``SearchResponse`` when the caller passed a
``QueryOptions`` and the bare ``SearchResult`` otherwise.

The typed scheduling errors: ``OverloadError`` (admission shed — the
request never entered the queue) and ``DeadlineExceeded`` (the request
expired before or inside the queue; no device work was spent).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional, Tuple

import numpy as np


class OverloadError(RuntimeError):
    """Admission control shed this request (token-bucket quota or the
    bounded pending queue) — it never entered the scheduler, no device
    work was spent, and the caller should back off. Typed so callers
    can distinguish load shedding from real failures; carries the
    decision context."""

    def __init__(self, msg: str, *, tenant: str = "default",
                 reason: str = "queue_full", depth: int = 0,
                 limit: Optional[int] = None):
        super().__init__(msg)
        self.tenant = tenant
        self.reason = reason        # "queue_full" | "quota"
        self.depth = depth
        self.limit = limit


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before its batch started scoring
    (at submit, or while queued). The scheduler drops expired requests
    instead of spending device work on answers nobody is waiting for."""

    def __init__(self, msg: str, *, deadline_ms: Optional[float] = None,
                 late_ms: float = 0.0, where: str = "queue"):
        super().__init__(msg)
        self.deadline_ms = deadline_ms
        self.late_ms = late_ms
        self.where = where          # "submit" | "queue"


@dataclasses.dataclass
class Query:
    """One sparse pattern query (1-D ``[Qn]``) or a stacked batch
    (2-D ``[L, Qn]``); ids int32 with pad < 0, vals float32. Arrays are
    copied and validated here so downstream stages can trust them."""
    ids: np.ndarray
    vals: np.ndarray

    def __post_init__(self):
        self.ids = np.array(self.ids, np.int32, copy=True)
        self.vals = np.array(self.vals, np.float32, copy=True)
        if self.ids.shape != self.vals.shape:
            raise ValueError(
                f"query ids {self.ids.shape} and vals {self.vals.shape} "
                f"differ")
        if self.ids.ndim not in (1, 2):
            raise ValueError(
                f"query must be 1-D (single) or 2-D (batch), got "
                f"{self.ids.ndim}-D")

    @property
    def is_single(self) -> bool:
        return self.ids.ndim == 1

    @property
    def n_rows(self) -> int:
        return 1 if self.is_single else int(self.ids.shape[0])

    def rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """The 2-D ``[L, Qn]`` view every scoring surface consumes (a
        single query becomes its own one-row batch)."""
        if self.is_single:
            return self.ids[None], self.vals[None]
        return self.ids, self.vals

    def flat(self) -> Tuple[np.ndarray, np.ndarray]:
        """The 1-D view the coalescing service consumes; a ``[1, Qn]``
        batch flattens, a taller batch is rejected (one Future resolves
        one query row)."""
        if self.is_single:
            return self.ids, self.vals
        if self.ids.shape[0] == 1:
            return self.ids[0], self.vals[0]
        raise ValueError(
            f"submit() takes one query per Future; got a batch of "
            f"{self.ids.shape[0]} rows (call search() for batches)")


@dataclasses.dataclass(frozen=True)
class QueryOptions:
    """How a request may be scheduled (DESIGN.md §7.3). All knobs
    default to the legacy FIFO/unbounded behavior, so
    ``QueryOptions()`` schedules exactly like no options at all.

    deadline_ms   latency budget from submission; the batcher flushes
                  early rather than miss it and drops the request with
                  ``DeadlineExceeded`` once it expires; the cluster
                  gather stops waiting on stragglers at the budget
                  (None = no deadline)
    priority      scheduling class; *lower runs first* (0 default).
                  Within a class, earliest deadline first, then
                  submission order — no-deadline requests sort after
                  deadlined ones of the same class
    tenant        admission-control accounting key (per-tenant
                  token-bucket quotas; DESIGN.md §7.3)
    k             per-query top-k override, truncating the configured
                  ``cfg.top_k`` rows (must be <= it)
    allow_partial consent to a best-effort gather: a deadline-bound
                  scatter may return merged top-k from the shards that
                  responded, flagged ``partial=True`` with the missing
                  shard list in stats. Without consent the gather
                  blocks for every shard (legacy behavior)
    hedging       None = the router's configured policy; True forces
                  straggler hedging on (default policy if the router
                  has none), False disables it for this request
    mode          scoring tier override (DESIGN.md §15): "exact" scans
                  every surviving slab, "approx" takes the per-segment
                  posting-candidate + exact-re-rank path, "auto" picks
                  by corpus size. None = the session's configured
                  default (which itself defaults to exact, so legacy
                  callers can never drift into the approximate tier)
    recall_target approx-tier recall@k goal in (0, 1]; mapped to a
                  candidate-pool multiplier when ``candidates`` is not
                  given explicitly (closer to 1.0 = wider pool)
    candidates    explicit per-segment top-C candidate-pool size for
                  the approx tier (wins over recall_target)
    """
    deadline_ms: Optional[float] = None
    priority: int = 0
    tenant: str = "default"
    k: Optional[int] = None
    allow_partial: bool = False
    hedging: Optional[bool] = None
    mode: Optional[str] = None
    recall_target: Optional[float] = None
    candidates: Optional[int] = None

    def __post_init__(self):
        if self.k is not None and self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if not self.tenant:
            raise ValueError("tenant must be a non-empty string")
        if self.priority != int(self.priority):
            raise ValueError(f"priority must be an int, got {self.priority}")
        if self.mode is not None and self.mode not in (
                "exact", "approx", "auto"):
            raise ValueError(
                f"mode must be 'exact', 'approx' or 'auto', got "
                f"{self.mode!r}")
        if self.recall_target is not None and not (
                0.0 < self.recall_target <= 1.0):
            raise ValueError(
                f"recall_target must be in (0, 1], got {self.recall_target}")
        if self.candidates is not None and self.candidates < 1:
            raise ValueError(
                f"candidates must be >= 1, got {self.candidates}")


@dataclasses.dataclass
class QueryStats:
    """What scheduling did to one request (per-query, rides on the
    ``SearchResponse``)."""
    queue_wait_ms: float = 0.0       # submit -> batch start
    partial: bool = False            # gather returned without every shard
    hedged: bool = False             # a hedge attempt won this query
    shards_missing: Tuple[int, ...] = ()   # shards absent from the merge
    deadline_ms: Optional[float] = None    # the budget the request ran under
    tenant: str = "default"


@dataclasses.dataclass
class SearchResponse:
    """Results plus the per-query scheduling stats. Quacks like
    ``SearchResult`` (``.doc_ids`` / ``.scores``) so result consumers
    are agnostic to which they received."""
    results: Any                     # SearchResult (or row thereof)
    stats: QueryStats

    @property
    def doc_ids(self):
        return self.results.doc_ids

    @property
    def scores(self):
        return self.results.scores


def coerce_request(query, q_vals=None, options: Optional[QueryOptions] = None,
                   *, surface: str = "search"
                   ) -> Tuple[Query, Optional[QueryOptions]]:
    """Boundary normalizer every public search surface shares: a typed
    ``Query`` passes through; the positional ``(q_ids, q_vals)`` array
    form still works but emits a ``DeprecationWarning`` (the shim the
    migration keeps until callers move)."""
    if isinstance(query, Query):
        if q_vals is not None:
            raise TypeError(
                f"{surface}: pass either Query or (q_ids, q_vals), not both")
        return query, options
    if q_vals is None:
        raise TypeError(
            f"{surface}: positional form needs both q_ids and q_vals "
            f"(or pass a repro_torch.serve.api.Query)")
    warnings.warn(
        f"{surface}(q_ids, q_vals) positional arrays are deprecated; "
        f"pass repro_torch.serve.api.Query(ids, vals) (and QueryOptions for "
        f"deadlines/priorities/partial-gather consent)",
        DeprecationWarning, stacklevel=3)
    return Query(query, q_vals), options


def truncate_k(result, k: Optional[int]):
    """Per-query top-k override: keep the first ``k`` of the engine's
    ``top_k`` columns (rows are score-descending, so the prefix IS the
    top-k). No-op when k is None or not smaller."""
    if k is None:
        return result
    ids, scores = result.doc_ids, result.scores
    if ids.shape[-1] <= k:
        return result
    return type(result)(ids[..., :k], scores[..., :k])
