"""ShardedStore — N FlashStores behind one CLUSTER.json (DESIGN.md §5.1).

The paper's capacity story is multi-slice: one slice handles up to 1 TB
and the system grows by adding slices. Here a corpus is split by a
partition policy into per-shard FlashStore directories, each optionally
replicated, under a single manifest:

    <root>/CLUSTER.json                     commit point (os.replace swap)
    <root>/gen-000/shard-00/rep-0/          a complete FlashStore
    <root>/gen-000/shard-00/rep-1/          byte-wise independent replica
    <root>/gen-000/shard-01/rep-0/          ...

``rebalance`` re-splits into a *new* generation directory and swaps the
manifest afterwards, so a crash mid-rebalance leaves the old generation
intact and at worst an orphan ``gen-NNN`` tree; the next rebalance
garbage-collects every generation directory the live manifest does not
reference (covering crashes on either side of the swap). Every shard keeps its own segment vocab filters
and manifest, so in-storage pruning and the per-shard compile cache are
exactly the single-store behavior.

A copy of ``repro.cluster.store``: the same directory layout and
``CLUSTER.json``, so a cluster written or rebalanced by either package
opens in the other. Host work only. The ``corpus=`` route splits the
corpus's rows by shard with numpy and writes each replica with the
port's vectorized ``FlashStore.append_corpus`` instead of a Python list
a document; the segment files are the bytes the ``docs=`` route writes.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster import partition as partition_lib
from repro_torch.core.corpus import Corpus
from repro_torch.storage import segment as segment_lib
from repro_torch.storage.store import (FlashStore, StoreStats,
                                       load_validated_manifest)

CLUSTER_MANIFEST = "CLUSTER.json"
CLUSTER_MAGIC = "rsps-cluster"
SUPPORTED_VERSIONS = (1,)
_REQUIRED_KEYS = ("version", "generation", "partition", "replicas",
                  "vocab_size", "shards")

log = logging.getLogger(__name__)

Doc = Tuple[int, Sequence[Tuple[int, int]]]


def _gen_dir(gen: int) -> str:
    return f"gen-{gen:03d}"


def _shard_rel(gen: int, shard: int, rep: int) -> str:
    return os.path.join(_gen_dir(gen), f"shard-{shard:02d}", f"rep-{rep}")


def _write_generation(root: str, docs: Optional[Sequence[Doc]],
                      corpus: Optional[Corpus],
                      part: partition_lib.Partitioner, replicas: int,
                      gen: int, *, vocab_size: int, docs_per_segment: int,
                      page_items: int, filter_kind: str) -> List[Dict]:
    """Partition ``docs`` (or the rows of ``corpus`` with doc_id >= 0)
    and write every shard/replica FlashStore of one generation. Input
    order is preserved within each shard, so shard contents are
    deterministic. Returns the manifest shard list."""
    # a crashed earlier attempt may have left a partial tree for this
    # generation (it was never committed — the manifest swap comes after
    # this returns); clear it so FlashStore.create doesn't collide
    shutil.rmtree(os.path.join(root, _gen_dir(gen)), ignore_errors=True)
    if corpus is not None:
        rows = np.flatnonzero(np.asarray(corpus.doc_ids) >= 0)
        ids = np.asarray(corpus.doc_ids, np.int64)[rows]
    else:
        ids = np.asarray([d for d, _ in docs], np.int64)
    assign = part.shard_of(ids) if ids.size else np.empty(0, np.int64)
    shards = []
    for s in range(part.n_shards):
        sel = np.flatnonzero(assign == s)
        if corpus is not None:
            r = rows[sel]
            part_rows = Corpus(corpus.doc_ids[r], corpus.ids[r],
                               corpus.vals[r], corpus.norms[r])
        else:
            part_rows = [docs[i] for i in sel]
        reps = []
        for rep in range(replicas):
            rel = _shard_rel(gen, s, rep)
            store = FlashStore.create(
                os.path.join(root, rel), vocab_size=vocab_size,
                docs_per_segment=docs_per_segment, page_items=page_items,
                filter_kind=filter_kind)
            if sel.size:
                if corpus is not None:
                    store.append_corpus(part_rows)
                else:
                    store.append_docs(part_rows)
            store.close()
            reps.append(rel)
        shards.append({"replicas": reps, "n_docs": int(sel.size)})
    return shards


def _write_manifest(root: str, manifest: Dict):
    tmp = os.path.join(root, CLUSTER_MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(root, CLUSTER_MANIFEST))


def build_sharded_store(root: str, docs: Optional[Sequence[Doc]] = None, *,
                        corpus: Optional[Corpus] = None, n_shards: int,
                        replicas: int = 1, policy: str = "hash",
                        vocab_size: int,
                        docs_per_segment: int = 4096,
                        page_items: int = segment_lib.DEFAULT_PAGE_ITEMS,
                        filter_kind: str = "auto",
                        partitioner: Optional[partition_lib.Partitioner]
                        = None) -> "ShardedStore":
    """Split a corpus into an N-shard, R-replica cluster at ``root``.

    Exactly one of ``docs`` ([(doc_id, [(word, count), ...])]) or
    ``corpus`` must be given. Each replica is written independently
    (identical content); CLUSTER.json lands last, so a partially-built
    directory is never openable."""
    if (docs is None) == (corpus is None):
        raise ValueError("exactly one of docs= or corpus= is required")
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    os.makedirs(root, exist_ok=True)
    if os.path.exists(os.path.join(root, CLUSTER_MANIFEST)):
        raise FileExistsError(f"cluster already exists at {root}")
    doc_ids = ([d for d, _ in docs] if corpus is None else
               np.asarray(corpus.doc_ids)[np.asarray(corpus.doc_ids) >= 0])
    part = partitioner or partition_lib.make_partitioner(
        policy, n_shards, doc_ids=doc_ids)
    if part.n_shards != n_shards:
        raise ValueError(f"partitioner covers {part.n_shards} shards, "
                         f"asked for {n_shards}")
    shards = _write_generation(
        root, docs, corpus, part, replicas, 0, vocab_size=vocab_size,
        docs_per_segment=docs_per_segment, page_items=page_items,
        filter_kind=filter_kind)
    manifest = {
        "magic": CLUSTER_MAGIC,
        "version": 1,
        "generation": 0,
        "partition": part.spec(),
        "replicas": replicas,
        "vocab_size": vocab_size,
        "docs_per_segment": docs_per_segment,
        "page_items": page_items,
        "filter_kind": filter_kind,
        "shards": shards,
    }
    _write_manifest(root, manifest)
    return ShardedStore(root, manifest)


class ShardedStore:
    def __init__(self, root: str, manifest: Dict):
        self.root = root
        self.manifest = manifest
        self._open_stores: Dict[Tuple[int, int], FlashStore] = {}

    # -- lifecycle -----------------------------------------------------
    @classmethod
    def open(cls, root: str) -> "ShardedStore":
        return cls(root, load_validated_manifest(
            os.path.join(root, CLUSTER_MANIFEST), magic=CLUSTER_MAGIC,
            versions=SUPPORTED_VERSIONS, required=_REQUIRED_KEYS,
            kind="sharded store"))

    def close(self):
        for store in self._open_stores.values():
            store.close()
        self._open_stores.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- properties ----------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.manifest["shards"])

    @property
    def replicas(self) -> int:
        return self.manifest["replicas"]

    @property
    def vocab_size(self) -> int:
        return self.manifest["vocab_size"]

    @property
    def generation(self) -> int:
        return self.manifest["generation"]

    @property
    def partitioner(self) -> partition_lib.Partitioner:
        return partition_lib.from_spec(self.manifest["partition"])

    @property
    def n_docs(self) -> int:
        """Documents per the manifest (replica 0 of every shard)."""
        return sum(s["n_docs"] for s in self.manifest["shards"])

    # -- shard access --------------------------------------------------
    def shard_path(self, shard: int, replica: int = 0) -> str:
        return os.path.join(
            self.root, self.manifest["shards"][shard]["replicas"][replica])

    def store(self, shard: int, replica: int = 0) -> FlashStore:
        key = (shard, replica)
        if key not in self._open_stores:
            self._open_stores[key] = FlashStore.open(
                self.shard_path(shard, replica))
        return self._open_stores[key]

    def stats(self) -> List[StoreStats]:
        """Per-shard StoreStats (replica 0) — the rebalance planner's
        view of where the documents and bytes actually sit."""
        return [self.store(s).stats() for s in range(self.n_shards)]

    def scan_corpus(self, nnz_pad: int, *, strict: bool = True) -> Corpus:
        """Decode the whole cluster (replica 0 of every shard) into one
        in-memory Corpus, in shard order. Tests and load generators; the
        query path streams per shard instead."""
        parts = [self.store(s).scan_corpus(nnz_pad, strict=strict)
                 for s in range(self.n_shards)]
        parts = [c for c in parts if c.n_docs]
        if not parts:
            return Corpus.empty(nnz_pad)
        return Corpus(
            np.concatenate([c.doc_ids for c in parts]),
            np.concatenate([c.ids for c in parts]),
            np.concatenate([c.vals for c in parts]),
            np.concatenate([c.norms for c in parts]))

    # -- rebalance -----------------------------------------------------
    def _gc_stale_generations(self):
        """Remove every ``gen-*`` tree the live manifest does not
        reference — leftovers of a crash on either side of a previous
        rebalance's manifest swap."""
        live = {rel.split(os.sep)[0] for sh in self.manifest["shards"]
                for rel in sh["replicas"]}
        for fn in os.listdir(self.root):
            path = os.path.join(self.root, fn)
            if fn.startswith("gen-") and fn not in live \
                    and os.path.isdir(path):
                log.info("rebalance(%s): removing stale generation %s",
                         self.root, fn)
                shutil.rmtree(path, ignore_errors=True)

    def _iter_doc_ids(self) -> np.ndarray:
        """Every doc id in the cluster (replica 0), read from the raw
        streams' header words — no pair decode, ~8 bytes/doc of RAM."""
        from repro_torch.core import stream_format
        out = []
        for s in range(self.n_shards):
            store = self.store(s)
            for e in store.entries:
                stream = store.segment(e.name).stream()
                hdrs = stream[(stream & stream_format.HEADER_BIT) != 0]
                out.append((hdrs & (stream_format.HEADER_BIT - 1))
                           .astype(np.int64))
                del stream, hdrs      # drop the mmap view before closing
                store.release(e.name)
        return np.concatenate(out) if out else np.empty(0, np.int64)

    def rebalance(self, *, n_shards: Optional[int] = None,
                  policy: Optional[str] = None,
                  replicas: Optional[int] = None,
                  docs_per_segment: Optional[int] = None) -> "ShardedStore":
        """Re-split the corpus into a new generation, streaming one old
        segment at a time: host memory holds at most one decoded segment
        plus one under-filled output chunk per target shard, so
        rebalance works at the beyond-RAM scale the tier exists for.
        The CLUSTER.json swap is the commit point; the old generation is
        deleted only after it, and stale generations from crashed
        attempts are garbage-collected first. Returns ``self``."""
        n_shards = n_shards or self.n_shards
        policy = policy or self.manifest["partition"]["policy"]
        replicas = replicas or self.replicas
        per = docs_per_segment or self.manifest["docs_per_segment"]
        plan = self.stats()
        log.info(
            "rebalance(%s): gen %d [%s] -> %d shards x %d replicas (%s); "
            "docs per shard before: %s", self.root, self.generation,
            self.manifest["partition"]["policy"], n_shards, replicas, policy,
            [st.n_docs for st in plan])
        self._gc_stale_generations()
        # pass 1 (cheap): ids only, to fit range bounds
        part = partition_lib.make_partitioner(
            policy, n_shards, doc_ids=self._iter_doc_ids())
        gen = self.generation + 1
        stores = [[FlashStore.create(
            os.path.join(self.root, _shard_rel(gen, s, r)),
            vocab_size=self.vocab_size, docs_per_segment=per,
            page_items=self.manifest["page_items"],
            filter_kind=self.manifest["filter_kind"])
            for r in range(replicas)] for s in range(n_shards)]
        bufs: List[List[Doc]] = [[] for _ in range(n_shards)]
        counts = [0] * n_shards

        def flush(s: int, final: bool = False):
            # full chunks of ``per`` (plus the tail when final), so the
            # segmentation matches a single append_docs of the shard.
            # Segments only — each store's manifest is written once at
            # the end (the generation is invisible until the CLUSTER.json
            # swap anyway, so per-chunk manifest commits would buy
            # nothing but O(segments^2) rewrite I/O).
            while len(bufs[s]) >= per or (final and bufs[s]):
                chunk = bufs[s][:per]
                del bufs[s][:per]
                for st in stores[s]:
                    st.manifest["segments"].append(
                        st._write_one_segment(chunk))
                counts[s] += len(chunk)

        # pass 2: stream old segments through the partitioner
        for s_old in range(self.n_shards):
            store = self.store(s_old)
            for e in store.entries:
                seg_docs = store.segment(e.name).docs()
                store.release(e.name)
                assign = part.shard_of(
                    np.asarray([d for d, _ in seg_docs], np.int64))
                for s in np.unique(assign):
                    bufs[s].extend(seg_docs[i]
                                   for i in np.flatnonzero(assign == s))
                    flush(int(s))
        shards = []
        for s in range(n_shards):
            flush(s, final=True)
            for st in stores[s]:
                st._write_manifest()
                st.close()
            shards.append({"replicas": [_shard_rel(gen, s, r)
                                        for r in range(replicas)],
                           "n_docs": counts[s]})
        self.close()
        manifest = dict(self.manifest, generation=gen, partition=part.spec(),
                        replicas=replicas, docs_per_segment=per,
                        shards=shards)
        old_gen = _gen_dir(self.generation)
        _write_manifest(self.root, manifest)        # commit point
        self.manifest = manifest
        shutil.rmtree(os.path.join(self.root, old_gen), ignore_errors=True)
        log.info("rebalance(%s): gen %d live; docs per shard after: %s",
                 self.root, gen, [s["n_docs"] for s in shards])
        return self


def rebalance(root: str, **kwargs) -> ShardedStore:
    """Open the cluster at ``root`` and re-split it (see
    ``ShardedStore.rebalance`` for the knobs)."""
    return ShardedStore.open(root).rebalance(**kwargs)
