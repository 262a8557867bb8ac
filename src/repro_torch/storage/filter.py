"""Per-segment vocabulary filters — the in-storage pattern filter
(DESIGN.md §3.2).

The paper's accelerator prunes data at the storage boundary: a query never
pays flash bandwidth for patterns that cannot match. Here each on-disk
segment carries a compact summary of the word ids it contains; a query
whose word-id set misses the summary skips the segment without reading a
single page.

Two summaries, one interface:

- ``BitmapFilter`` — one bit per vocab word. Exact (no false positives);
  at the paper's 141k-word vocabulary it is ~17 KB/segment, negligible
  next to megabytes of pages. Default whenever the vocab is bounded.
- ``BloomFilter`` — classic double-hashed Bloom over the word ids, for
  open/huge key spaces (the 19-bit key limit makes this rare, but protein
  k-mer or edge-label spaces can be configured larger).

Both serialize to ``(meta dict, raw bytes)`` so the segment footer can
embed them; ``from_meta`` reconstructs either kind.

A planner probing hundreds of segments asks the *same* query against
every one, so the query-side work — dedup, validation, and above all the
two splitmix64 mixes behind the Kirsch–Mitzenmacher scheme — is hoisted
into a per-query ``QueryProbe``: build it once, then each segment verdict
costs only a table lookup (bitmap) or a modulo + gather (Bloom).

A copy of ``repro.storage.filter``: ``splitmix64`` and the Bloom bit
positions are the reference's bit for bit, so a store written by either
package filters the same way in the other.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _as_word_ids(word_ids) -> np.ndarray:
    ids = np.asarray(word_ids).reshape(-1).astype(np.int64)
    return np.unique(ids[ids >= 0])


def splitmix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer (avalanche so sequential ids spread).

    STABLE CONTRACT: these exact constants are baked into persisted
    formats — Bloom filter bit positions inside segment files and the
    cluster tier's hash partition assignments under CLUSTER.json.
    Changing them requires a format-version bump on both."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class QueryProbe:
    """Filter-independent probe state for one query: the unique valid
    word ids plus their Kirsch–Mitzenmacher base hashes. h1/h2 depend
    only on the ids and the stable splitmix64 constants, never on a
    particular filter's geometry, so every segment verdict reuses them
    — only the ``% n_bits`` fold is per-filter."""

    __slots__ = ("ids", "h1", "h2")

    def __init__(self, word_ids):
        self.ids = _as_word_ids(word_ids)
        u = self.ids.astype(np.uint64)
        self.h1 = splitmix64(u)
        self.h2 = splitmix64(u ^ np.uint64(0xA5A5A5A5A5A5A5A5)) | np.uint64(1)


class BitmapFilter:
    """Exact one-bit-per-word membership bitmap."""

    kind = "bitmap"

    def __init__(self, bits: np.ndarray, vocab_size: int):
        self.bits = bits                     # uint8 [ceil(vocab/8)]
        self.vocab_size = vocab_size

    @classmethod
    def build(cls, word_ids, vocab_size: int) -> "BitmapFilter":
        ids = _as_word_ids(word_ids)
        if ids.size and int(ids.max()) >= vocab_size:
            raise ValueError(
                f"word id {int(ids.max())} >= vocab_size {vocab_size}")
        bits = np.zeros(-(-vocab_size // 8), np.uint8)
        np.bitwise_or.at(bits, ids >> 3, np.uint8(1) << (ids & 7).astype(np.uint8))
        return cls(bits, vocab_size)

    def contains(self, word_ids) -> np.ndarray:
        ids = np.asarray(word_ids, np.int64).reshape(-1)
        ok = (ids >= 0) & (ids < self.vocab_size)
        safe = np.where(ok, ids, 0)
        hit = (self.bits[safe >> 3] >> (safe & 7).astype(np.uint8)) & 1
        return (hit.astype(bool)) & ok

    def contains_any(self, word_ids) -> bool:
        return bool(self.contains(word_ids).any())

    def contains_any_probe(self, probe: QueryProbe) -> bool:
        """Same verdict as ``contains_any(probe source ids)`` with the
        query-side dedup/validation already paid."""
        ids = probe.ids
        if ids.size == 0:
            return False
        ok = ids < self.vocab_size
        safe = np.where(ok, ids, 0)
        hit = (self.bits[safe >> 3] >> (safe & 7).astype(np.uint8)) & 1
        return bool((hit.astype(bool) & ok).any())

    def estimated_fpr(self) -> float:
        """Exact membership — never a false positive."""
        return 0.0

    def to_bytes(self) -> bytes:
        return self.bits.tobytes()

    def meta(self) -> Dict:
        return {"kind": self.kind, "vocab_size": self.vocab_size}


class BloomFilter:
    """Double-hashed Bloom filter over word ids (splitmix64 mixing)."""

    kind = "bloom"

    def __init__(self, words: np.ndarray, n_bits: int, n_hashes: int):
        self.words = words                   # uint64 [n_bits/64]
        self.n_bits = n_bits
        self.n_hashes = n_hashes

    _mix = staticmethod(splitmix64)

    def _bit_positions(self, ids: np.ndarray) -> np.ndarray:
        """[n] ids -> [n, n_hashes] bit indices (Kirsch–Mitzenmacher)."""
        h1 = self._mix(ids)
        h2 = self._mix(ids ^ np.uint64(0xA5A5A5A5A5A5A5A5)) | np.uint64(1)
        ks = np.arange(self.n_hashes, dtype=np.uint64)
        with np.errstate(over="ignore"):
            hh = h1[:, None] + ks[None, :] * h2[:, None]
        return (hh % np.uint64(self.n_bits)).astype(np.int64)

    @classmethod
    def build(cls, word_ids, n_bits: Optional[int] = None,
              n_hashes: int = 4, bits_per_key: int = 10) -> "BloomFilter":
        ids = _as_word_ids(word_ids).astype(np.uint64)
        if n_bits is None:
            n_bits = max(64, 1 << int(np.ceil(np.log2(
                max(1, ids.size) * bits_per_key))))
        f = cls(np.zeros(-(-n_bits // 64), np.uint64), n_bits, n_hashes)
        if ids.size:
            pos = f._bit_positions(ids).reshape(-1)
            np.bitwise_or.at(f.words, pos >> 6,
                             np.uint64(1) << (pos & 63).astype(np.uint64))
        return f

    def contains(self, word_ids) -> np.ndarray:
        ids = np.asarray(word_ids, np.int64).reshape(-1)
        ok = ids >= 0
        pos = self._bit_positions(np.where(ok, ids, 0).astype(np.uint64))
        hit = (self.words[pos >> 6] >> (pos & 63).astype(np.uint64)) & np.uint64(1)
        return hit.astype(bool).all(axis=1) & ok

    def contains_any(self, word_ids) -> bool:
        return bool(self.contains(word_ids).any())

    def contains_any_probe(self, probe: QueryProbe) -> bool:
        """Same verdict as ``contains_any(probe source ids)`` reusing the
        probe's precomputed h1/h2 — only the ``% n_bits`` fold and the
        word gather are paid per segment (must stay bit-compatible with
        ``_bit_positions``)."""
        if probe.ids.size == 0:
            return False
        ks = np.arange(self.n_hashes, dtype=np.uint64)
        with np.errstate(over="ignore"):
            hh = probe.h1[:, None] + ks[None, :] * probe.h2[:, None]
        pos = (hh % np.uint64(self.n_bits)).astype(np.int64)
        hit = (self.words[pos >> 6]
               >> (pos & 63).astype(np.uint64)) & np.uint64(1)
        return bool(hit.astype(bool).all(axis=1).any())

    def estimated_fpr(self) -> float:
        """Estimated false-positive rate from the observed bit load:
        fpr ~= (set_bits / n_bits) ** n_hashes, the standard Bloom
        estimate for a membership probe of an absent key."""
        if self.n_bits == 0:
            return 1.0
        set_bits = int(np.unpackbits(
            self.words.view(np.uint8)).sum())
        # words may over-allocate past n_bits; those bits are never set
        load = min(1.0, set_bits / float(self.n_bits))
        return float(load ** self.n_hashes)

    def to_bytes(self) -> bytes:
        return self.words.tobytes()

    def meta(self) -> Dict:
        return {"kind": self.kind, "n_bits": self.n_bits,
                "n_hashes": self.n_hashes}


VocabFilter = (BitmapFilter, BloomFilter)


def build_filter(word_ids, vocab_size: Optional[int] = None,
                 kind: str = "auto", **bloom_kw):
    """Build the segment summary. ``auto`` prefers the exact bitmap when
    the vocab is bounded (<= 2^21 words = 256 KB bitmap), else Bloom."""
    if kind == "auto":
        kind = "bitmap" if vocab_size and vocab_size <= (1 << 21) else "bloom"
    if kind == "bitmap":
        if not vocab_size:
            raise ValueError("bitmap filter needs vocab_size")
        return BitmapFilter.build(word_ids, vocab_size)
    if kind == "bloom":
        return BloomFilter.build(word_ids, **bloom_kw)
    raise ValueError(f"unknown filter kind {kind!r}")


def from_meta(meta: Dict, raw: bytes):
    """Reconstruct a filter from its footer metadata + raw bytes."""
    if meta["kind"] == "bitmap":
        return BitmapFilter(np.frombuffer(raw, np.uint8).copy(),
                            meta["vocab_size"])
    if meta["kind"] == "bloom":
        return BloomFilter(np.frombuffer(raw, np.uint64).copy(),
                           meta["n_bits"], meta["n_hashes"])
    raise ValueError(f"unknown filter kind {meta['kind']!r}")
