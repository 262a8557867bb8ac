"""Doc-id partitioning policies for the cluster tier (DESIGN.md §5.1).

The paper scales capacity by adding flash slices; which slice owns a
document is a pure function of its doc id so the router never needs a
lookup table:

- ``HashPartitioner`` — splitmix64-mixed doc id modulo the shard count.
  Uniform regardless of id distribution; the default for write-heavy or
  unknown corpora.
- ``RangePartitioner`` — contiguous doc-id ranges split at explicit
  bounds. ``fit`` picks equal-count quantile bounds from an observed id
  set, so time- or tenant-ordered ids keep locality (and their segment
  vocab filters stay clustered, preserving per-shard skip-rate).

Both vectorize over arrays, serialize to a JSON ``spec`` embedded in
``CLUSTER.json``, and guarantee every non-negative doc id maps to
exactly one shard in ``[0, n_shards)`` — the invariant the partition
property tests pin.

A copy of ``repro.cluster.partition``: the same ``shard_of`` arrays and
the same JSON ``spec``, so a ``CLUSTER.json`` written by either package
routes the same way in the other.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# the same splitmix64 avalanche the Bloom filter uses (a STABLE-CONTRACT
# function: hash partition assignments persist under CLUSTER.json):
# sequential doc ids must spread uniformly over shards
from repro_torch.storage.filter import splitmix64 as _mix


def _check_ids(doc_ids) -> np.ndarray:
    ids = np.asarray(doc_ids, np.int64).reshape(-1)
    if ids.size and int(ids.min()) < 0:
        raise ValueError("doc ids must be >= 0 (negative ids are padding)")
    return ids


class Partitioner:
    """Maps doc ids to shard indices. Subclasses are pure functions of
    (spec, doc_id): no per-doc state, so routers and writers agree."""

    kind: str = "?"
    n_shards: int = 0

    def shard_of(self, doc_ids) -> np.ndarray:
        """[n] doc ids (>= 0) -> [n] shard indices in [0, n_shards)."""
        raise NotImplementedError

    def spec(self) -> Dict:
        """JSON-serializable policy description (``from_spec`` inverts)."""
        raise NotImplementedError


class HashPartitioner(Partitioner):
    kind = "hash"

    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards

    def shard_of(self, doc_ids) -> np.ndarray:
        ids = _check_ids(doc_ids)
        return (_mix(ids.astype(np.uint64))
                % np.uint64(self.n_shards)).astype(np.int64)

    def spec(self) -> Dict:
        return {"policy": "hash", "n_shards": self.n_shards}


class RangePartitioner(Partitioner):
    """Shard s owns ids in ``(bounds[s-1], bounds[s]]`` (the last shard
    is unbounded above). ``len(bounds) == n_shards - 1``; duplicate
    bounds yield empty shards, which the router handles."""

    kind = "range"

    def __init__(self, bounds: Sequence[int]):
        b = np.asarray(list(bounds), np.int64).reshape(-1)
        if b.size and np.any(np.diff(b) < 0):
            raise ValueError("range bounds must be ascending")
        self.bounds = b
        self.n_shards = b.size + 1

    @classmethod
    def fit(cls, doc_ids, n_shards: int) -> "RangePartitioner":
        """Equal-count quantile bounds over the observed id set."""
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        ids = np.unique(_check_ids(doc_ids))
        if n_shards == 1:
            return cls(np.empty(0, np.int64))
        if ids.size == 0:
            return cls(np.arange(1, n_shards, dtype=np.int64))
        cuts = (np.arange(1, n_shards) * ids.size) // n_shards
        return cls(ids[np.maximum(cuts, 1) - 1])

    def shard_of(self, doc_ids) -> np.ndarray:
        ids = _check_ids(doc_ids)
        return np.searchsorted(self.bounds, ids, side="left").astype(np.int64)

    def spec(self) -> Dict:
        return {"policy": "range", "bounds": self.bounds.tolist()}


def from_spec(spec: Dict) -> Partitioner:
    """Rebuild a partitioner from its ``CLUSTER.json`` spec."""
    policy = spec.get("policy")
    if policy == "hash":
        return HashPartitioner(int(spec["n_shards"]))
    if policy == "range":
        return RangePartitioner(spec["bounds"])
    raise ValueError(f"unknown partition policy {policy!r}")


def make_partitioner(policy: str, n_shards: int,
                     doc_ids=None) -> Partitioner:
    """Policy name -> partitioner. ``range`` fits quantile bounds from
    ``doc_ids`` (required); ``hash`` ignores them."""
    if policy == "hash":
        return HashPartitioner(n_shards)
    if policy == "range":
        if doc_ids is None:
            raise ValueError("range policy needs doc_ids to fit bounds")
        return RangePartitioner.fit(doc_ids, n_shards)
    raise ValueError(f"unknown partition policy {policy!r}")
