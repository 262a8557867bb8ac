"""IngestPipeline — WAL-backed appends, delta-segment seals, and online
compaction over a FlashStore, without ever blocking or perturbing
readers (DESIGN.md §6).

The write path is the LSM split SpANNS applies to sparse indices:

    append(doc) ──▶ WriteAheadLog (durable tail, §6.1)
                └─▶ MemTable (searchable tail)
    seal: memtable ──▶ immutable delta segment(s) (Fig. 8 format + vocab
          filter, exactly §3.1) ──▶ manifest swap ──▶ WAL reset
    Compactor: folds the store's underfull tail run into full segments,
          commits with the same atomic manifest swap, GCs the replaced
          files afterwards (§6.2)

Concurrency contract (two locks, lock order write → state):

- ``_write_lock`` serializes *writers*: appends, seal commits, and the
  compactor's commit step. Held across file I/O only on the write path.
- ``_state_lock`` guards the shared in-memory state — the manifest's
  segment list and the memtable — and is held only for list swaps and
  snapshot capture (microseconds). Readers touch no other lock.

A query calls ``capture()`` and gets a ``Snapshot``: the segment entry
list plus a copy of the memtable, taken in one ``_state_lock`` section,
registered with the pipeline. While any snapshot is registered the
compactor parks replaced files in a graveyard instead of unlinking
them (drained when the last snapshot closes), so a snapshot opens its
segments lazily — one fd at a time, like the cold read path — and
still sees exactly the manifest generation + sealed deltas + memtable
state of capture time no matter how many folds commit underneath it.
Because a seal moves documents from memtable to manifest inside one
``_state_lock`` section, a snapshot can never see a document twice or
lose one mid-seal.

Crash recovery ordering (each arrow is a durability point):

    segment file rename ──▶ durable manifest (+``ingest_seq``) ──▶ WAL reset

A crash before the manifest swap leaves an orphan segment (GC'd by
compaction) and an intact WAL; a crash after it but before the WAL
reset is idempotent because replay skips records with
``seq <= manifest["ingest_seq"]``.

A copy of ``repro.ingest.pipeline``. The writer and the compactor do
host work only (WAL, memtable, segment encode and file I/O); every
launch and upload happens on the thread that scores a query. A fold
invalidates the folded names' slab-cache entries (``bump_generation``)
while a snapshot in flight may still score a slab it already fetched:
the slab's tensors stay alive through that reference, so nothing here
frees device memory.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.corpus import Corpus
from repro_torch.ingest.memtable import MemTable
from repro_torch.ingest.wal import WriteAheadLog
from repro_torch.obs import Obs, default_obs
from repro_torch.storage import segment as segment_lib
from repro_torch.storage.store import FlashStore, SegmentEntry

WAL_NAME = "wal.log"

log = logging.getLogger(__name__)

Doc = Tuple[int, Sequence[Tuple[int, int]]]


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Knobs for one store's write path.

    ``seal_docs``: memtable size that triggers a seal (delta segments of
    roughly this many documents). ``fold_min_segments``: the compactor
    folds the store's underfull tail run once it is at least this many
    segments long. ``fsync``: fsync the WAL on every append (durable to
    the platter) — off by default, matching the flash tier's
    mmap-not-NVMe simplification (DESIGN.md §14). ``auto_compact``
    starts the background compactor thread; ``compact_poll_s`` is its
    idle poll interval (seals nudge it immediately)."""
    seal_docs: int = 512
    fold_min_segments: int = 4
    auto_compact: bool = True
    compact_poll_s: float = 0.25
    fsync: bool = False


@dataclasses.dataclass
class IngestStats:
    appended: int = 0          # documents accepted this process
    replayed: int = 0          # documents recovered from the WAL on open
    seals: int = 0             # memtable -> delta-segment commits
    compactions: int = 0       # background/manual folds committed
    segments_folded: int = 0   # segments rewritten by those folds


class MemCorpusCache:
    """The last memtable ELL build, keyed ``(n_docs, last_seq, nnz_pad)``
    (the memtable key fingerprints its contents): a read-heavy workload
    re-scores an unchanged memtable every query and must not pay the
    codec again each time. Only the latest build is retained; a
    concurrent-miss recompute is benign."""

    def __init__(self):
        self._last: Dict[Tuple[int, int, int],
                         Tuple[Optional[Corpus], int]] = {}

    def get(self, docs: List[Doc], key: Tuple[int, int],
            nnz_pad: int) -> Tuple[Optional[Corpus], int]:
        k = tuple(key) + (nnz_pad,)
        hit = self._last.get(k)
        if hit is None:
            hit = MemTable.docs_to_corpus(docs, nnz_pad)
            self._last = {k: hit}
        return hit


class Snapshot:
    """One query's frozen view of a live store: the segment entry list
    plus the memtable documents, captured atomically under the state
    lock. Segment handles open *lazily* (``segment``), one at a time
    like the non-ingest read path, so a snapshot costs zero fds up
    front and the bounded-descriptor invariant of the plan executor's
    loader (``storage/plan.py``) holds on live stores too. The
    pipeline defers compaction GC while any snapshot is registered
    (``_snapshot_closed``), so a lazily opened file is guaranteed to
    still exist. ``close()`` is idempotent.

    On a mesh the leader's snapshot travels as its ``spec`` (the
    entries, generation, memtable documents and memtable key), and a
    follower scores ``from_spec``'s form: no pipeline, its segments
    opened lazily from its own handle on the same store directory, its
    memtable's ELL built by ``MemTable.docs_to_corpus`` as the
    leader's is, so bit for bit the leader's. It registers nothing: the
    leader keeps its own snapshot registered until every follower has
    finished the batch (``distributed/lockstep.py``)."""

    def __init__(self, entries: List[SegmentEntry], mem_docs: List[Doc],
                 mem_key: Tuple[int, int], generation: int,
                 pipeline: Optional["IngestPipeline"] = None, *,
                 store: Optional[FlashStore] = None,
                 corpus_cache: Optional[MemCorpusCache] = None):
        self.entries = entries
        self.mem_docs = mem_docs
        self._mem_key = tuple(mem_key)
        self._generation = generation
        self._pipeline = pipeline
        self._store = store if store is not None else pipeline.store
        self._corpus_cache = (corpus_cache if corpus_cache is not None
                              else pipeline._mem_corpus)
        self._segments: Dict[str, segment_lib.Segment] = {}

    @classmethod
    def from_spec(cls, spec: Dict, store: FlashStore,
                  corpus_cache: MemCorpusCache) -> "Snapshot":
        """A leader's snapshot, rebuilt on a follower over ``store`` (this
        rank's handle on the leader's store directory, whose cache token
        keys this rank's slab cache and memo)."""
        return cls(spec["entries"], spec["mem_docs"], spec["mem_key"],
                   spec["generation"], store=store,
                   corpus_cache=corpus_cache)

    @property
    def spec(self) -> Dict:
        """What a follower needs to rebuild this view (``from_spec``)."""
        return {"entries": self.entries, "generation": self._generation,
                "mem_docs": self.mem_docs, "mem_key": self._mem_key}

    @property
    def max_segment_docs(self) -> int:
        return max((e.n_docs for e in self.entries), default=0)

    @property
    def cache_token(self):
        """Slab-cache identity (DESIGN.md §4.2): snapshot segments are
        the store's own immutable files, so they share its token."""
        return self._store.cache_token

    @property
    def generation(self) -> int:
        """The store generation this segment list was captured at
        (under the state lock) — what the plan records. Compared
        against ``live_generation`` at cache-admission time, so a
        snapshot straggling past a fold (even one landing between
        capture and planning) can never re-admit graveyard slabs the
        fold just invalidated."""
        return self._generation

    @property
    def live_generation(self) -> int:
        """The store's current generation; a follower's view is the
        leader's current one (segment names are never reused, so a
        slab it admits stays right)."""
        if self._pipeline is None:
            return self._generation
        return self._store.generation

    @property
    def memo_state(self):
        """Memo-cache key component (storage/memo.py): capture-time
        generation plus the memtable fingerprint, so a memoized result
        can never outlive an append, seal, or compaction."""
        return (self._generation, self._mem_key)

    def segment(self, name: str) -> segment_lib.Segment:
        if name not in self._segments:
            self._segments[name] = segment_lib.Segment(
                os.path.join(self._store.root, name))
        return self._segments[name]

    def release(self, name: str):
        seg = self._segments.pop(name, None)
        if seg is not None:
            seg.close()

    def memtable_corpus(self, nnz_pad: int) -> Tuple[Optional[Corpus], int]:
        return self._corpus_cache.get(self.mem_docs, self._mem_key, nnz_pad)

    def close(self):
        for seg in self._segments.values():
            seg.close()
        self._segments = {}
        if self._pipeline is not None:
            self._pipeline._snapshot_closed()
            self._pipeline = None


class IngestPipeline:
    def __init__(self, store: FlashStore, cfg: Optional[IngestConfig] = None,
                 obs: Optional[Obs] = None):
        self.store = store
        self.cfg = cfg or IngestConfig()
        if self.cfg.seal_docs < 1:
            raise ValueError("seal_docs must be >= 1")
        self._write_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._compact_lock = threading.Lock()   # one fold at a time
        self._closed = False
        self.stats = IngestStats()
        # §8 registry handles, resolved once — append() touches exactly
        # one pre-bound counter beyond its existing work
        self.obs = obs if obs is not None else default_obs()
        reg = self.obs.registry
        self._c_append = reg.counter("ingest_appends")
        self._c_seal = reg.counter("ingest_seals")
        self._c_sealed_docs = reg.counter("ingest_docs_sealed")
        self._c_fold = reg.counter("ingest_compactions")
        self._c_folded = reg.counter("ingest_segments_folded")
        self._h_seal = reg.histogram("ingest_seal_ms")
        self._h_fold = reg.histogram("ingest_fold_ms")
        self.wal = WriteAheadLog(os.path.join(store.root, WAL_NAME),
                                 fsync=self.cfg.fsync)
        if self.wal.repairs:
            reg.counter("ingest_wal_repairs").inc(self.wal.repairs)
        self.memtable = MemTable()
        # replay: only records newer than what seals already made durable
        # (an empty WAL after a post-seal crash must not rewind last_seq
        # below the manifest's high-water mark, or fresh appends would be
        # skipped by the next replay)
        ingest_seq = int(store.manifest.get("ingest_seq", 0))
        self.wal.last_seq = max(self.wal.last_seq, ingest_seq)
        for seq, doc in self.wal.records(after_seq=ingest_seq):
            self.memtable.add(seq, doc)
            self.stats.replayed += 1
        if self.stats.replayed:
            reg.counter("ingest_wal_replayed").inc(self.stats.replayed)
            log.info("ingest(%s): replayed %d document(s) from the WAL",
                     store.root, self.stats.replayed)
        self._compact_wake = threading.Event()
        self._compactor: Optional[threading.Thread] = None
        # snapshot bookkeeping: while any snapshot is registered, files a
        # fold replaced go to the graveyard instead of being unlinked, so
        # lazily opened snapshot segments can never hit a missing file
        self._live_snapshots = 0
        self._graveyard: List[str] = []
        self._mem_corpus = MemCorpusCache()
        with self._write_lock:
            if len(self.memtable) >= self.cfg.seal_docs:
                self._seal_locked()
        if self.cfg.auto_compact:
            self._compactor = threading.Thread(
                target=self._compact_loop, daemon=True,
                name=f"compactor-{os.path.basename(store.root) or 'store'}")
            self._compactor.start()

    # -- write path ----------------------------------------------------
    def append(self, doc_id: int, pairs: Sequence[Tuple[int, int]]) -> int:
        """Durably log + make searchable one document; returns its WAL
        sequence number. Seals synchronously when the memtable reaches
        ``seal_docs`` (writers pay the seal; readers never do)."""
        pairs = sorted((int(w), int(c)) for w, c in pairs)
        if pairs and pairs[-1][0] >= self.store.vocab_size:
            raise ValueError(
                f"word id {pairs[-1][0]} >= store vocab_size "
                f"{self.store.vocab_size}")
        with self._write_lock:
            # checked under the lock: close() also takes it, so a writer
            # can never reach the WAL after close() shut it
            if self._closed:
                raise RuntimeError("ingest pipeline is closed")
            seq = self.wal.append((int(doc_id), pairs))
            with self._state_lock:
                self.memtable.add(seq, (int(doc_id), pairs))
            self.stats.appended += 1
            self._c_append.inc()
            if len(self.memtable) >= self.cfg.seal_docs:
                self._seal_locked()
        return seq

    def seal(self) -> int:
        """Fold the current memtable into delta segment(s) now (e.g.
        before a planned shutdown or a cluster rebalance). Returns the
        number of documents sealed."""
        with self._write_lock:
            return self._seal_locked()

    def _seal_locked(self) -> int:
        """Memtable -> immutable delta segment(s) -> durable manifest ->
        WAL reset. Caller holds ``_write_lock``; with it held the
        memtable can only be ours, so copy-then-clear is exact."""
        if self._closed:
            raise RuntimeError("ingest pipeline is closed")
        docs = self.memtable.docs()
        if not docs:
            return 0
        t0 = time.perf_counter()
        last_seq = self.memtable.last_seq
        per = self.store.manifest["docs_per_segment"]
        entries = []
        for lo in range(0, len(docs), per):
            with self._state_lock:
                name = self.store._reserve_segment_name()
            # durable: the manifest below is fsynced, so the data it
            # references must hit disk first or power loss leaves a
            # durable manifest naming torn pages
            entries.append(self.store._write_segment_file(
                name, docs[lo:lo + per], durable=True))
        # disk first, then memory: a crash at the commit point leaves the
        # in-memory state (and therefore live snapshots) strictly behind
        # disk — replay reconciles; docs are never visible twice
        segs = self.store.manifest["segments"] + entries
        new_manifest = dict(self.store.manifest, segments=segs,
                            ingest_seq=last_seq)
        self.store._write_manifest(durable=True,        # commit point
                                   manifest=new_manifest)
        with self._state_lock:
            self.store.manifest["segments"] = segs
            self.store.manifest["ingest_seq"] = last_seq
            self.memtable.clear_prefix(len(docs))
            # inside the state lock so a concurrent capture never pairs
            # the new segment list with the old generation (seal adds,
            # replaces nothing — this is a pure counter bump)
            self.store.bump_generation()
        self.wal.reset()
        self.stats.seals += 1
        self._c_seal.inc()
        self._c_sealed_docs.inc(len(docs))
        self._h_seal.observe((time.perf_counter() - t0) * 1e3)
        self._compact_wake.set()
        return len(docs)

    flush = seal

    # -- read path -----------------------------------------------------
    def capture(self) -> Snapshot:
        """Atomically freeze (segment entries, memtable) for one query —
        a list copy plus a registration bump under the state lock, so
        appends never stall behind a capture and a capture costs no
        file descriptors. Registration is what keeps the view valid:
        the compactor defers GC of replaced files while any snapshot is
        live, so the snapshot's lazily opened segments always exist.
        Callers must ``close()`` the snapshot (idempotent) or deferred
        GC never drains."""
        with self._state_lock:
            entries = self.store.entries
            mem_docs = self.memtable.docs()
            mem_key = (len(mem_docs), self.memtable.last_seq)
            generation = self.store.generation
            self._live_snapshots += 1
        return Snapshot(entries, mem_docs, mem_key, generation, self)

    def _snapshot_closed(self):
        with self._state_lock:
            self._live_snapshots -= 1
            doomed = []
            if self._live_snapshots == 0 and self._graveyard:
                doomed, self._graveyard = self._graveyard, []
        for name in doomed:
            try:
                os.unlink(os.path.join(self.store.root, name))
            except FileNotFoundError:
                pass

    # -- compaction ----------------------------------------------------
    def _fold_range(self) -> Tuple[int, List[SegmentEntry]]:
        """(start index, tail entries) of the underfull tail run worth
        folding, or (len, [])."""
        per = self.store.manifest["docs_per_segment"]
        with self._state_lock:
            entries = self.store.entries
        i = len(entries)
        for j, e in enumerate(entries):
            if e.n_docs < per:
                i = j
                break
        tail = entries[i:]
        if len(tail) < max(self.cfg.fold_min_segments, 2):
            return len(entries), []
        return i, tail

    def compact_once(self) -> int:
        """Fold the underfull tail run into full segments. Streaming and
        segment writes happen with no lock held; only the manifest swap
        takes the write lock, so appends stall for microseconds and
        readers never stall at all. Returns segments folded (0 = no-op).
        Serialized by ``_compact_lock`` (compactor thread vs manual
        calls)."""
        with self._compact_lock:
            return self._compact_once_locked()

    def _compact_once_locked(self) -> int:
        i, tail = self._fold_range()
        if not tail:
            return 0
        t0 = time.perf_counter()
        per = self.store.manifest["docs_per_segment"]
        buf: List[Doc] = []
        new_entries: List[Dict] = []

        def flush_chunk(final=False):
            while len(buf) >= per or (final and buf):
                with self._state_lock:
                    name = self.store._reserve_segment_name()
                # durable: the fold's commit unlinks the old (possibly
                # long-durable) tail, so its replacement must be on disk
                # before the fsynced manifest references it
                new_entries.append(self.store._write_segment_file(
                    name, buf[:per], durable=True))
                del buf[:per]

        for e in tail:       # immutable files: no lock while streaming
            with segment_lib.Segment(
                    os.path.join(self.store.root, e.name)) as seg:
                buf.extend(seg.docs())
            flush_chunk()
        flush_chunk(final=True)
        with self._write_lock:
            # stable with the write lock held: only seals and other
            # commits mutate the list, and they all take this lock
            cur = self.store.manifest["segments"]
            # seals only ever append, so [i : i+len(tail)] is still
            # exactly the run we folded; anything after it arrived
            # during the fold and must survive the swap
            assert [e["name"] for e in cur[i:i + len(tail)]] \
                == [e.name for e in tail]
            segs = cur[:i] + new_entries + cur[i + len(tail):]
            self.store._write_manifest(                 # commit point
                durable=True,
                manifest=dict(self.store.manifest, segments=segs))
            with self._state_lock:
                self.store.manifest["segments"] = segs
                # GC the replaced files — unless a registered snapshot
                # may still lazily open them, in which case they wait in
                # the graveyard until the last snapshot closes (a crash
                # before then leaves orphans; compact() GCs those)
                doomed = [] if self._live_snapshots else \
                    [e.name for e in tail]
                if not doomed:
                    self._graveyard.extend(e.name for e in tail)
            # precise cache invalidation (DESIGN.md §4.2): the folded
            # tail names are out of the live manifest; a snapshot that
            # still scores one reloads it from the graveyard (a miss)
            self.store.bump_generation(removed=[e.name for e in tail])
        for name in doomed:
            try:
                os.unlink(os.path.join(self.store.root, name))
            except FileNotFoundError:
                pass
        self.stats.compactions += 1
        self.stats.segments_folded += len(tail)
        self._c_fold.inc()
        self._c_folded.inc(len(tail))
        self._h_fold.observe((time.perf_counter() - t0) * 1e3)
        log.info("compactor(%s): folded %d tail segment(s) into %d",
                 self.store.root, len(tail), len(new_entries))
        return len(tail)

    def _compact_loop(self):
        while not self._closed:
            self._compact_wake.wait(timeout=self.cfg.compact_poll_s)
            self._compact_wake.clear()
            if self._closed:
                return
            try:
                self.compact_once()
            except Exception:               # keep serving; next seal retries
                log.exception("compactor(%s): fold failed", self.store.root)

    # -- lifecycle -----------------------------------------------------
    def close(self, *, seal: bool = False):
        """Stop the compactor and close the WAL. Unsealed documents stay
        in the WAL and are replayed on the next open; pass ``seal=True``
        to fold them into segments first."""
        if self._closed:
            return
        if seal:
            self.seal()
        with self._write_lock:
            # under the write lock: an append that lost the race to us
            # sees _closed and raises instead of writing a closed WAL
            if self._closed:
                return
            self._closed = True
            self.wal.close()
        # join outside the lock — a mid-fold compactor needs it to commit
        self._compact_wake.set()
        if self._compactor is not None:
            self._compactor.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
