"""Recurrent-query memo cache (DESIGN.md §15.3).

"Leveraging Recurrent Patterns in Graph Accelerators" (PAPERS.md) makes
the case this module implements: real query streams repeat, and the
cheapest query is the one whose *answer* is already in hand. The memo
cache sits one level above the SlabCache — where the slab cache
memoizes decoded segment data keyed by (store, segment, shape), the
memo cache memoizes whole search results keyed by a normalized query
fingerprint plus everything that could change the answer:

    (cache_token, generation, memtable key, slab fmt,
     top_k, mode, candidates, query fingerprint)

Invalidation mirrors the slab cache's generation discipline, but
structurally: the store generation and the memtable fingerprint are
*part of the key*, so a seal/compaction/append bump makes every stale
entry unreachable the instant it happens — there is no window in which
a result from the old view can be served against the new one. Dead
generations age out of the bounded LRU; ``drop_store`` purges a closing
store's entries eagerly.

The fingerprint is order- and padding-insensitive: a query row hashes
its valid (id, value) pairs in sorted order, so the same logical query
arriving with different pad widths or pair orderings hits the same
entry (results are identical — scoring is a sum over pairs).

A copy of ``repro.storage.memo``. Keys are internal to a process: the
port's ``slab_fmt`` (a key field) names ``gpu_packed``'s own layout.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Hashable, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class MemoStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    drops: int = 0          # entries purged by drop_store
    entries: int = 0


def query_fingerprint(q_ids: np.ndarray, q_vals: np.ndarray) -> str:
    """Canonical digest of a query batch [L, Qn] (pad < 0): per row,
    the valid (id, value) pairs sorted by (id, value) — two encodings
    of the same logical query always collide, two different queries
    practically never do (blake2b-128)."""
    q_ids = np.atleast_2d(np.asarray(q_ids))
    q_vals = np.atleast_2d(np.asarray(q_vals))
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(q_ids.shape[0]).tobytes())
    for r in range(q_ids.shape[0]):
        ids = q_ids[r].astype(np.int64)
        vals = q_vals[r].astype(np.float32)
        keep = ids >= 0
        ids, vals = ids[keep], vals[keep]
        order = np.lexsort((vals, ids))
        h.update(b"\x00row")
        h.update(ids[order].tobytes())
        h.update(vals[order].tobytes())
    return h.hexdigest()


def memo_key(cache_token: Hashable, memo_state: Tuple, fmt: str,
             top_k: int, mode: str, candidates: int,
             q_ids: np.ndarray, q_vals: np.ndarray) -> Tuple:
    """Full result key. ``memo_state`` is the view's
    ``(generation, memtable key)`` — see FlashStore.memo_state /
    Snapshot.memo_state — which is what makes cross-generation serving
    structurally impossible rather than merely checked."""
    return (cache_token, memo_state, fmt, int(top_k), mode,
            int(candidates), query_fingerprint(q_ids, q_vals))


class MemoCache:
    """Thread-safe bounded LRU: fingerprint key -> (result, stats)."""

    def __init__(self, max_entries: int = 256):
        if max_entries <= 0:
            raise ValueError("max_entries must be positive")
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, object]" = OrderedDict()
        self._stats = MemoStats()

    def get(self, key: Tuple):
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self._stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self._stats.hits += 1
            return hit

    def put(self, key: Tuple, value) -> int:
        """Insert (idempotent on re-insert). Returns evictions."""
        ev = 0
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self._entries[key] = value
                return 0
            self._entries[key] = value
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                ev += 1
            self._stats.evictions += ev
            self._stats.entries = len(self._entries)
        return ev

    def drop_store(self, cache_token: Hashable) -> int:
        """Purge every entry of one store (session close)."""
        with self._lock:
            dead = [k for k in self._entries if k[0] == cache_token]
            for k in dead:
                del self._entries[k]
            self._stats.drops += len(dead)
            self._stats.entries = len(self._entries)
            return len(dead)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats_snapshot(self) -> MemoStats:
        with self._lock:
            return dataclasses.replace(self._stats,
                                       entries=len(self._entries))
