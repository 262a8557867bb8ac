"""SlabCache — byte-budgeted LRU of decoded, device-resident slabs
(DESIGN.md §4.2).

The paper's accelerator keeps hot data next to the compute; the host
analogue is keeping a hot segment's *decoded* form — the ``DeviceSlab``
or ``PackedSlab`` the engine scores — resident on the card across
queries, so a cache hit skips the disk read, the decode, and the upload
entirely. Keys are ``(store token, segment name, nnz_pad, slab_docs,
slab fmt)``:

- the **store token** is unique per live `FlashStore` instance, so a
  reopened (possibly crash-recovered) store can never alias a previous
  instance's entries even if segment names were reused on disk;
- segment files are immutable and segment ids monotonic within one
  store instance (§3.1), so a keyed entry can never go stale;
- ``nnz_pad`` / ``slab_docs`` pin the decode and the padded launch
  shape — a store whose largest segment grows simply misses and
  re-decodes at the new shape;
- the **slab fmt** is the engine's layout (``engine.slab_fmt``): ELL,
  packed words or fused tiles of one segment never alias, so sessions of
  different backends may share one cache.

Entries carry the slab's truncation count and decoded doc count so a
warm query reports the exact `SearchStats` a cold one would.
Invalidation is precise: manifest mutations call ``invalidate`` with
the replaced segment names (see ``FlashStore.bump_generation``).
Eviction is LRU under a byte budget; an item larger than the whole
budget is scored but never admitted. All methods are thread-safe —
prefetcher workers and shard-router threads share one instance.

A copy of ``repro.storage.slabcache`` but for ``slab_nbytes``, which
charges the budget the slab's device bytes (``numel() *
element_size()`` of its tensors).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Hashable, Iterable, NamedTuple, Optional, Tuple

DEFAULT_CACHE_BYTES = 256 * 1024 * 1024


class CachedSlab(NamedTuple):
    """One decoded segment: the device-resident slab plus the decode
    metadata a warm query must still report (bit-identical stats)."""
    slab: object          # engine.DeviceSlab or fused.PackedSlab
    n_docs: int           # decoded (pre-padding) document rows
    n_trunc: int          # pairs truncated by nnz_pad at decode time
    nbytes: int           # device footprint charged to the budget


@dataclasses.dataclass
class CacheStats:
    """Lifetime counters (process scope, across every sharer)."""
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


def slab_nbytes(slab) -> int:
    """Device footprint of a ``DeviceSlab`` or ``PackedSlab``: the bytes
    of its tensors."""
    return sum(t.numel() * t.element_size() for t in slab)


# (store token, name, nnz_pad, slab_docs, slab fmt)
Key = Tuple[Hashable, str, int, int, str]


def slab_key(token: Hashable, name: str, nnz_pad: int,
             slab_docs: int, fmt: str = "ell") -> Key:
    """The one cache-key constructor — planner peeks and executor
    get/puts must key identically or every planned hit silently
    degrades to a miss. ``fmt`` is the engine's slab layout
    (``engine.slab_fmt``): an ELL DeviceSlab and a fused PackedSlab of
    the same segment are different device objects and must never alias
    (the fused fmt also carries its doc-tile side, since re-tiling
    changes the layout)."""
    return (token, name, nnz_pad, slab_docs, fmt)


class SlabCache:
    def __init__(self, max_bytes: int = DEFAULT_CACHE_BYTES):
        if max_bytes < 0:
            raise ValueError("max_bytes must be >= 0")
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Key, CachedSlab]" = OrderedDict()
        self._bytes = 0
        self.stats = CacheStats()

    @classmethod
    def resolve(cls, slab_cache: "Optional[SlabCache]",
                cache_bytes: Optional[int]) -> "Optional[SlabCache]":
        """The one knob ladder every session tier uses: an explicit
        ``slab_cache`` is shared as-is; otherwise ``cache_bytes`` sizes
        a private cache (None = default budget, 0 = disabled)."""
        if slab_cache is not None:
            return slab_cache
        if cache_bytes is None:
            return cls()
        return cls(cache_bytes) if cache_bytes > 0 else None

    # -- introspection -------------------------------------------------
    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Key) -> bool:
        return self.peek(key)

    def keys(self):
        with self._lock:
            return list(self._entries)

    def stats_snapshot(self) -> CacheStats:
        """A point-in-time copy of the lifetime counters, taken under
        the cache lock. ``cache_stats`` surfaces must return this, not
        the live ``stats`` object: a lock-free read of the mutating
        dataclass can pair a ``hits`` from one moment with a ``misses``
        from another, so ``hit_rate`` mid-flight was not any state the
        cache ever held."""
        with self._lock:
            return dataclasses.replace(self.stats)

    # -- read path -----------------------------------------------------
    def peek(self, key: Key) -> bool:
        """Membership without touching LRU order or hit/miss counters —
        the Planner's verdict probe (the executor's ``get`` is what
        counts, so planned-but-evicted entries surface as misses)."""
        with self._lock:
            return key in self._entries

    def get(self, key: Key) -> Optional[CachedSlab]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return hit

    # -- write path ----------------------------------------------------
    def put(self, key: Key, slab, *, n_docs: int, n_trunc: int,
            admit=None) -> int:
        """Admit one decoded slab, evicting LRU entries to fit the byte
        budget. Returns how many entries were evicted. A slab larger
        than the whole budget is not admitted (returns 0).

        ``admit`` (a zero-arg callable) is evaluated *under the cache
        lock*: because ``invalidate`` also runs under it, a guard like
        the executor's generation check cannot race a concurrent
        invalidation — either the guard already sees the bumped
        generation (skip), or the entry lands before the invalidate
        acquires the lock and is dropped by it."""
        nbytes = slab_nbytes(slab)
        evicted = 0
        with self._lock:
            if admit is not None and not admit():
                return 0
            if nbytes > self.max_bytes:
                return 0
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            while self._entries and self._bytes + nbytes > self.max_bytes:
                _, dead = self._entries.popitem(last=False)
                self._bytes -= dead.nbytes
                evicted += 1
            self._entries[key] = CachedSlab(slab, int(n_docs),
                                            int(n_trunc), nbytes)
            self._bytes += nbytes
            self.stats.evictions += evicted
        return evicted

    # -- invalidation --------------------------------------------------
    def invalidate(self, token: Hashable, names: Iterable[str]) -> int:
        """Drop the entries of ``names`` for one store instance — the
        precise set a manifest mutation (fold/compact) replaced. A live
        snapshot that still scores a replaced file reloads it from the
        graveyard (a miss, never a wrong answer)."""
        names = set(names)
        dropped = 0
        with self._lock:
            for key in [k for k in self._entries
                        if k[0] == token and k[1] in names]:
                self._bytes -= self._entries.pop(key).nbytes
                dropped += 1
            self.stats.invalidations += dropped
        return dropped

    def drop_store(self, token: Hashable) -> int:
        """Drop every entry of one store instance (session close —
        nothing will ever key on this token again)."""
        dropped = 0
        with self._lock:
            for key in [k for k in self._entries if k[0] == token]:
                self._bytes -= self._entries.pop(key).nbytes
                dropped += 1
        return dropped

    def clear(self):
        """Empty the cache (benchmarks' cold-start lever). Lifetime
        counters are preserved."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0
