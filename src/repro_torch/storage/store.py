"""FlashStore — a directory of segments plus a manifest (DESIGN.md §3.1).

The persistent analogue of the paper's flash slices: a corpus too large
for aggregate device memory lives as Fig. 8 segment files; queries stream
only the segments whose vocabulary filter matches. Layout:

    <root>/MANIFEST.json        store config + ordered segment entries
    <root>/seg-000000.rsps      paged stream + filter + footer (segment.py)
    <root>/seg-000001.rsps      ...

The manifest is the commit point: segments are written (atomically) first,
then the manifest is swapped via ``os.replace``; a crash mid-append leaves
the previous manifest intact and at worst an orphan segment file, which
``compact()`` garbage-collects.

A copy of ``repro.storage.store``: the manifest, ``cache_token``,
``generation`` and ``register_cache`` are unchanged, and a store
directory written by either package opens in the other.
``append_corpus`` encodes ELL rows with numpy (``stream_format.
encode_rows``) instead of a Python loop a document; the files are the
same bytes.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import stream_format
from repro_torch.core.corpus import Corpus, from_stream
from repro_torch.storage import segment as segment_lib

MANIFEST = "MANIFEST.json"
SEGMENT_SUFFIX = ".rsps"
STORE_MAGIC = "rsps-store"
SUPPORTED_VERSIONS = (1,)
_REQUIRED_KEYS = ("version", "vocab_size", "docs_per_segment", "page_items",
                  "filter_kind", "next_segment_id", "segments")

log = logging.getLogger(__name__)


def fsync_dir(path: str):
    """fsync a directory so a just-renamed or just-unlinked dirent is
    durable. A crash after ``os.replace(manifest)`` but before the
    directory metadata reaches disk could resurrect the *old* manifest —
    whose segment list references files a post-swap GC already deleted,
    or re-references segments the swap replaced."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class StoreFormatError(ValueError):
    """The directory is not a readable FlashStore of a supported version:
    missing or garbled manifest, foreign magic, or an unknown config
    version. The message always names the offending path, so a router
    opening N stores can report which shard directory is bad."""


def load_validated_manifest(path: str, *, magic: str,
                            versions: Tuple[int, ...],
                            required: Tuple[str, ...], kind: str) -> Dict:
    """Read + validate a JSON manifest, raising StoreFormatError (always
    naming ``path``) on anything that is not a ``kind`` manifest of a
    supported version. Shared by FlashStore and ShardedStore so the two
    validation paths cannot drift. Manifests written before the magic
    key existed (version-1, all required keys present) are accepted."""
    try:
        with open(path) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise StoreFormatError(
            f"{path}: no manifest — {os.path.dirname(path) or '.'!r} "
            f"is not a {kind}") from None
    except json.JSONDecodeError as e:
        raise StoreFormatError(
            f"{path}: manifest is not valid JSON ({e})") from None
    if not isinstance(manifest, dict):
        raise StoreFormatError(
            f"{path}: manifest is {type(manifest).__name__}, not an "
            f"object (stale or foreign directory)")
    got = manifest.get("magic")
    if got is not None and got != magic:
        raise StoreFormatError(
            f"{path}: manifest magic {got!r} != {magic!r} "
            f"(stale or foreign directory)")
    if manifest.get("version") not in versions:
        raise StoreFormatError(
            f"{path}: unsupported {kind} version "
            f"{manifest.get('version')!r} (supported: {list(versions)}; "
            f"stale or foreign directory?)")
    missing = [k for k in required if k not in manifest]
    if missing:
        raise StoreFormatError(
            f"{path}: manifest missing keys {missing} "
            f"(stale or foreign directory?)")
    return manifest


@dataclasses.dataclass(frozen=True)
class SegmentEntry:
    name: str
    n_docs: int
    n_items: int
    doc_id_min: int
    doc_id_max: int


@dataclasses.dataclass(frozen=True)
class StoreStats:
    """Cheap store summary (manifest + segment footers via plain seeks —
    no page mmap). The cluster tier's rebalance planner reads these."""
    n_segments: int
    n_docs: int
    n_items: int
    n_bytes: int
    filter_kind: str


# unique per FlashStore *instance*: a reopened (possibly
# crash-recovered) store must never alias a previous instance's slab
# cache entries even if segment names were reused on disk
_CACHE_TOKENS = itertools.count(1)


class FlashStore:
    def __init__(self, root: str, manifest: Dict):
        self.root = root
        self.manifest = manifest
        self._open_segments: Dict[str, segment_lib.Segment] = {}
        # DESIGN.md §4.2: manifest-mutation bookkeeping for the device
        # slab cache — ``generation`` counts commits, registered caches
        # get precise invalidations for replaced segment names
        self.cache_token = next(_CACHE_TOKENS)
        self.generation = 0
        # id(cache) -> [cache, refcount]: refcounted so N sessions
        # sharing one cache over one store register/unregister cleanly,
        # and a long-lived store never accumulates dead sessions' caches
        self._caches: Dict[int, List] = {}

    def register_cache(self, cache):
        """Attach a SlabCache for invalidation callbacks. Paired with
        ``unregister_cache`` at session close (refcounted)."""
        slot = self._caches.setdefault(id(cache), [cache, 0])
        slot[1] += 1

    def unregister_cache(self, cache) -> bool:
        """Detach one registration (session close). Returns True when it
        was the last one — only then may the caller drop this store's
        entries from the cache; earlier a sibling session still serving
        from them would lose its warm set."""
        slot = self._caches.get(id(cache))
        if slot is None:
            return False
        slot[1] -= 1
        if slot[1] <= 0:
            del self._caches[id(cache)]
            return True
        return False

    @property
    def live_generation(self) -> int:
        """Alias so FlashStore and ingest Snapshot expose the same
        plan-view surface (a snapshot's ``generation`` is capture-time,
        its ``live_generation`` is the store's current one)."""
        return self.generation

    @property
    def memo_state(self):
        """Everything beyond the segment files that could change a
        query's answer on this view — keyed into the memo cache
        (storage/memo.py). No memtable here, so generation alone."""
        return (self.generation, None)

    def bump_generation(self, removed: Sequence[str] = ()):
        """Record one manifest mutation (append/seal/fold/compact) and
        drop exactly the replaced segment names from every registered
        cache. Dropping is a perf event, never a correctness one — a
        live snapshot that still scores a replaced file reloads it from
        the graveyard (§6.2)."""
        self.generation += 1
        if removed:
            for cache, _ in list(self._caches.values()):
                cache.invalidate(self.cache_token, removed)

    # -- lifecycle -----------------------------------------------------
    @classmethod
    def create(cls, root: str, *, vocab_size: int,
               docs_per_segment: int = 4096,
               page_items: int = segment_lib.DEFAULT_PAGE_ITEMS,
               filter_kind: str = "auto") -> "FlashStore":
        os.makedirs(root, exist_ok=True)
        if os.path.exists(os.path.join(root, MANIFEST)):
            raise FileExistsError(f"store already exists at {root}")
        manifest = {
            "magic": STORE_MAGIC,
            "version": 1,
            "vocab_size": vocab_size,
            "docs_per_segment": docs_per_segment,
            "page_items": page_items,
            "filter_kind": filter_kind,
            "next_segment_id": 0,
            "segments": [],
        }
        store = cls(root, manifest)
        store._write_manifest()
        return store

    @classmethod
    def open(cls, root: str) -> "FlashStore":
        return cls(root, load_validated_manifest(
            os.path.join(root, MANIFEST), magic=STORE_MAGIC,
            versions=SUPPORTED_VERSIONS, required=_REQUIRED_KEYS,
            kind="FlashStore"))

    def close(self):
        for seg in self._open_segments.values():
            seg.close()
        self._open_segments.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _write_manifest(self, durable: bool = False,
                        manifest: Optional[Dict] = None):
        """Swap MANIFEST.json atomically. ``durable=True`` additionally
        fsyncs the tmp file before the rename and the directory after it
        — required wherever the swap is a commit point whose loss would
        resurrect deleted state (compaction GC, ingest seals). Passing
        ``manifest`` writes that dict *without* touching ``self.manifest``
        — the ingest tier commits to disk first and swaps the in-memory
        state after, so a crash at the commit point leaves the live
        object behind disk (safe) rather than ahead of it."""
        tmp = os.path.join(self.root, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self.manifest if manifest is None else manifest,
                      f, indent=1)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, MANIFEST))
        if durable:
            fsync_dir(self.root)

    # -- properties ----------------------------------------------------
    @property
    def entries(self) -> List[SegmentEntry]:
        return [SegmentEntry(**e) for e in self.manifest["segments"]]

    @property
    def n_segments(self) -> int:
        return len(self.manifest["segments"])

    @property
    def n_docs(self) -> int:
        return sum(e["n_docs"] for e in self.manifest["segments"])

    @property
    def max_segment_docs(self) -> int:
        """Largest segment (slab padding target so every slab launches
        at one shape — DESIGN.md §3.3)."""
        return max((e["n_docs"] for e in self.manifest["segments"]),
                   default=0)

    @property
    def vocab_size(self) -> int:
        return self.manifest["vocab_size"]

    def stats(self) -> StoreStats:
        """Store summary from the manifest plus per-segment footers read
        with plain seeks — nothing is mmapped, so this is cheap even on a
        cold store. ``filter_kind`` is the kind actually written to the
        segments (the manifest may say ``auto``)."""
        entries = self.manifest["segments"]
        n_bytes = 0
        kinds = set()
        for e in entries:
            path = os.path.join(self.root, e["name"])
            n_bytes += os.path.getsize(path)
            kinds.add(
                segment_lib.read_footer(path)["filter"]["meta"]["kind"])
        if len(kinds) == 1:
            kind = kinds.pop()
        elif kinds:
            kind = "mixed"
        else:
            kind = self.manifest["filter_kind"]
        return StoreStats(n_segments=len(entries),
                          n_docs=sum(e["n_docs"] for e in entries),
                          n_items=sum(e["n_items"] for e in entries),
                          n_bytes=n_bytes, filter_kind=kind)

    # -- write path ----------------------------------------------------
    def _reserve_segment_name(self) -> str:
        """Claim the next segment id (mutates the in-memory manifest;
        persisted with the next manifest write). Split from the file
        write so the ingest tier can take ids under its state lock while
        writing segment data with no lock held."""
        sid = self.manifest["next_segment_id"]
        self.manifest["next_segment_id"] = sid + 1
        return f"seg-{sid:06d}{SEGMENT_SUFFIX}"

    def _write_segment_file(self, name: str, chunk,
                            durable: bool = False) -> Dict:
        """Write one segment file (atomic tmp+rename) and return its
        manifest entry. Neither the segment list nor the manifest file
        is touched — callers commit. ``durable=True`` fsyncs the data
        first: mandatory when the committing manifest write will itself
        be durable, else power loss yields a durable manifest naming a
        torn segment."""
        return self._write_stream_file(name, stream_format.encode(chunk),
                                       durable)

    def _write_stream_file(self, name: str, stream: np.ndarray,
                           durable: bool = False) -> Dict:
        """``_write_segment_file`` for an encoded Fig. 8 stream."""
        footer = segment_lib.write_stream_segment(
            os.path.join(self.root, name), stream,
            page_items=self.manifest["page_items"],
            vocab_size=self.manifest["vocab_size"],
            filter_kind=self.manifest["filter_kind"], fsync=durable)
        return {"name": name, "n_docs": footer["n_docs"],
                "n_items": footer["n_items"],
                "doc_id_min": footer["doc_id_min"],
                "doc_id_max": footer["doc_id_max"]}

    def _write_one_segment(self, chunk, durable: bool = False) -> Dict:
        return self._write_segment_file(self._reserve_segment_name(), chunk,
                                        durable)

    def append_docs(self, docs: Sequence[Tuple[int, Sequence[Tuple[int, int]]]],
                    docs_per_segment: Optional[int] = None) -> List[str]:
        """Append documents, splitting into <= docs_per_segment segments.
        Returns the new segment names."""
        per = docs_per_segment or self.manifest["docs_per_segment"]
        entries = [self._write_one_segment(docs[lo:lo + per])
                   for lo in range(0, len(docs), per)]
        return self._commit_appended(entries)

    def append_corpus(self, corpus: Corpus,
                      docs_per_segment: Optional[int] = None) -> List[str]:
        """``append_docs`` of the corpus's rows with ``doc_id >= 0``, in
        row order (pad rows skipped), encoded with numpy."""
        per = docs_per_segment or self.manifest["docs_per_segment"]
        rows = np.flatnonzero(np.asarray(corpus.doc_ids) >= 0)
        entries = []
        for lo in range(0, rows.size, per):
            sel = rows[lo:lo + per]
            stream = stream_format.encode_rows(
                corpus.doc_ids[sel], corpus.ids[sel], corpus.vals[sel])
            entries.append(self._write_stream_file(
                self._reserve_segment_name(), stream))
        return self._commit_appended(entries)

    def _commit_appended(self, entries: List[Dict]) -> List[str]:
        self.manifest["segments"].extend(entries)
        self._write_manifest()
        self.bump_generation()
        return [e["name"] for e in entries]

    def compact(self, docs_per_segment: Optional[int] = None) -> int:
        """Rewrite all segments at full occupancy (merging small appends)
        and drop orphan segment files. Streams one old segment at a time,
        so host memory stays bounded at ~one segment regardless of store
        size. Returns the new segment count."""
        per = docs_per_segment or self.manifest["docs_per_segment"]
        old_entries = list(self.manifest["segments"])
        new_entries: List[Dict] = []
        buf: List = []
        for e in old_entries:
            seg = self.segment(e["name"])
            buf.extend(seg.docs())
            self.release(e["name"])
            while len(buf) >= per:
                # durable: compaction deletes the originals below, so the
                # rewrites must be on disk before the fsynced manifest
                # (and the GC) makes them the only copy
                new_entries.append(self._write_one_segment(buf[:per],
                                                           durable=True))
                del buf[:per]
        if buf:
            new_entries.append(self._write_one_segment(buf, durable=True))
        self.close()
        self.manifest["segments"] = new_entries
        self.manifest["docs_per_segment"] = per
        # commit point: durable swap (fsync file + directory) — without
        # the directory fsync a crash here could resurrect the old
        # manifest after the loop below has GC'd the segments it names
        self._write_manifest(durable=True)
        live = {e["name"] for e in new_entries}
        replaced = {e["name"] for e in old_entries}
        for fn in os.listdir(self.root):
            if fn.endswith(SEGMENT_SUFFIX) and fn not in live:
                if fn not in replaced:
                    # never referenced by any manifest: a crashed append
                    log.warning("compact(%s): removing orphan segment %s",
                                self.root, fn)
                else:
                    log.info("compact(%s): removing replaced segment %s",
                             self.root, fn)
                os.unlink(os.path.join(self.root, fn))
        self.bump_generation(removed=[e["name"] for e in old_entries])
        return self.n_segments

    # -- read path -----------------------------------------------------
    def segment(self, name: str) -> segment_lib.Segment:
        if name not in self._open_segments:
            self._open_segments[name] = segment_lib.Segment(
                os.path.join(self.root, name))
        return self._open_segments[name]

    def release(self, name: str):
        """Close one segment's fd/mmap (readers drop handles as soon as a
        segment is filtered out or decoded, so a search never holds more
        than a few descriptors regardless of store size)."""
        seg = self._open_segments.pop(name, None)
        if seg is not None:
            seg.close()

    def segments(self) -> Iterable[segment_lib.Segment]:
        return [self.segment(e["name"]) for e in self.manifest["segments"]]

    def scan_corpus(self, nnz_pad: int, *, strict: bool = True) -> Corpus:
        """Decode the whole store into one in-memory Corpus (tests and
        small stores; the query path never needs this)."""
        streams = [seg.stream() for seg in self.segments()]
        if not streams:
            return Corpus.empty(nnz_pad)
        return from_stream(np.concatenate(streams), nnz_pad, strict=strict)
