"""PatternSearchEngine — the paper's in-storage accelerator on one CUDA
card, the port of ``repro.core.engine`` (DESIGN.md §2).

The corpus lives in the card's memory. A search merges its L queries into
one id stream with L value columns, scores the corpus against it with a
kernel (``gpu``: ELL, ``gpu_packed``: Fig. 8 words, ``gpu_fused``: decode +
match + top-k over packed doc tiles; ``torch``: the gather path, only when
asked for by name), takes the top-k and returns it to the host. Only the
queries go in and the top-k comes out; the corpus never moves.

Streaming mode handles corpora larger than the card: slabs are uploaded
and scored one after another, with top-k merged across slabs.

Query shapes are *bucketed*: L pads to the next power of two and the
merged id stream to a capacity proportional to that L bucket, so a
session serving batches of any size up to ``max_batch`` uses at most
``log2(max_batch) + 1`` launch shapes; ``compile_stats`` reports the
distinct (Lp, Qp, n_docs) launch keys seen (on a mesh, the rank's own
Lp / tp columns and rows), and the ``obs`` registry's
``engine_compile_traces`` counter counts each new one (the reference
counts jit traces there). With ``obs.device_fence`` on, ``stage_ms``
splits a request into ``score_dispatch`` (uploads and launches, on the
host clock) and ``score_device`` (``torch.cuda.synchronize`` until the
card is done).

On a mesh (``ctx=``, a ``repro_torch.distributed.MeshCtx``) each rank is
one process that holds one row block of the corpus: rows pad to a
multiple of the ``data`` axes' size (the paper's K partitions) and the
rank uploads only its block. The ranks call ``search`` in lockstep with
the same queries (behind a ``SearchService`` rank 0 leads each batch and
the others follow it, ``distributed/lockstep.py``). Each merges the
whole batch, scores its block against its contiguous L / tp columns of
the merged values (the ``model`` axis; L pads to a power of two times
tp), takes a local top-k over its global doc ids, reduces it over each
``data`` axis (``core.topk.tree_topk``) and gathers the columns back
over ``model``, so every rank returns the whole
[L, k] result, bit for bit the single-device one. ``ctx=None`` (a
``single_device_ctx``, no DeviceMesh) is the single-device path as it
was: no reduction runs. ``gpu_fused`` scores one device's packed tiles
only.

On the CPU (``device="cpu"``) every kernel wrapper runs its plain PyTorch
version; that is how the tests hold this engine against the JAX one.

Every upload, launch and readback holds ``repro_torch.device.LAUNCHES``
shared, so a profiler session can start and stop with no launch in
flight (ROADMAP C16).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.paper_search import SearchConfig
from repro_torch.core import topk as topk_lib
from repro_torch.core.corpus import Corpus
from repro_torch.core.stream_format import VAL_MASK
from repro_torch.device import LAUNCHES, DeviceLike, resolve
from repro_torch.distributed import compat
from repro_torch.distributed.meshctx import MeshCtx, single_device_ctx
from repro_torch.kernels import fused as kfused
from repro_torch.kernels import ops as kops
from repro_torch.kernels.fused import PackedSlab
from repro_torch.kernels.sparse_match_packed import pack as pack_ell
from repro_torch.kernels.tiling import FixedTiling, TilingStrategy
from repro_torch.obs import Obs, default_obs


@dataclasses.dataclass
class SearchResult:
    doc_ids: np.ndarray   # [L, k] int64 (-1 for no result)
    scores: np.ndarray    # [L, k] cosine


class DeviceSlab(NamedTuple):
    """A corpus slab already uploaded to the card — the unit the
    streaming path scores. Produced by ``put_slab``."""
    ids: torch.Tensor     # [n, K] int32 (packed words for gpu_packed)
    vals: torch.Tensor    # [n, K] float32
    norms: torch.Tensor   # [n] float32
    doc_ids: torch.Tensor  # [n] int32


SlabLike = Union[Corpus, DeviceSlab, PackedSlab]


def _require_integral_counts(vals: np.ndarray, backend: str):
    """The packed/fused backends carry values in the Fig. 8 12-bit count
    field — arbitrary floats would be silently clipped/rounded."""
    v = vals[vals != 0]
    if v.size and (not np.all(v == np.round(v)) or v.min() < 0
                   or v.max() > VAL_MASK):
        raise ValueError(
            f"backend={backend!r} needs integral counts in "
            f"[0, {VAL_MASK}] (Fig. 8 packing); use backend='torch' or "
            "'gpu' for arbitrary float values")


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class PatternSearchEngine:
    def __init__(self, corpus: Optional[Corpus], cfg: SearchConfig,
                 device: DeviceLike = None, backend: str = "gpu",
                 obs: Optional[Obs] = None,
                 tiling: Optional[TilingStrategy] = None, *,
                 ctx: Optional[MeshCtx] = None):
        """``corpus=None`` builds a streaming-only engine (no resident
        corpus): callers use ``search_streaming`` / ``put_slab``.
        ``device`` defaults to the CUDA card (``repro_torch.device``).
        ``ctx`` runs the engine on a mesh, on the ctx's device (``device``
        may only repeat it); None is one device.
        ``obs`` mirrors new launch keys into the shared metrics registry;
        None uses the process default.
        ``tiling`` picks the fused backend's doc tile (DESIGN.md §12.3);
        None uses ``FixedTiling`` at the config's shapes."""
        if backend not in kops.BACKENDS:
            raise ValueError(f"backend must be one of {kops.BACKENDS}, "
                             f"got {backend!r}")
        if ctx is None:
            ctx = single_device_ctx(device)
        elif device is not None and resolve(device) != ctx.device:
            raise ValueError(f"device {device} is not the mesh ctx's "
                             f"{ctx.device}")
        if backend == "gpu_fused" and ctx.size != 1:
            raise ValueError(
                "backend='gpu_fused' is single-device (packed doc tiles "
                f"are not mesh-sharded); mesh has {ctx.size} devices — "
                "use 'gpu' or 'torch' there")
        self.ctx = ctx
        self.device = ctx.device
        self.cfg = cfg
        self.backend = backend
        self.obs = obs if obs is not None else default_obs()
        # registry handle resolved once: a request touches it only when
        # its launch key is new
        self._trace_counter = self.obs.registry.counter(
            "engine_compile_traces")
        if corpus is None:
            corpus = Corpus.empty(cfg.nnz_pad)
        if corpus.ids.size and int(corpus.ids.max()) >= cfg.vocab_size:
            raise ValueError(
                f"corpus word ids reach {int(corpus.ids.max())} but "
                f"cfg.vocab_size={cfg.vocab_size}")
        rows = ctx.dp_size
        corpus = corpus.pad_docs_to(-(-corpus.n_docs // rows) * rows)
        self.corpus = corpus
        self.tiling = tiling if tiling is not None else FixedTiling(
            cfg.block_docs, cfg.block_query)
        self.f_tiles: Optional[torch.Tensor] = None
        self.d_ids = self.d_vals = self.d_norms = self.d_docids = None
        if backend == "gpu_fused":
            self._block_docs = self.tiling.doc_tile(
                nnz_pad=cfg.nnz_pad, n_docs=corpus.n_docs)
            tiles, _, _ = kfused.tile_stream(
                kfused.corpus_to_stream(corpus),
                block_docs=self._block_docs, nnz_pad=cfg.nnz_pad,
                pad_docs_to=corpus.n_docs)
            # one packed tile matrix is the whole resident corpus
            self.f_tiles = self._upload(tiles.view(np.int32))
        else:
            self._block_docs = cfg.block_docs
            slab = self.put_slab(corpus)
            self.d_ids, self.d_vals, self.d_norms, self.d_docids = slab
        # distinct launch keys (the rank's columns, Qp, the rank's rows),
        # in first-seen order
        self._launch_keys: list = []

    # ------------------------------------------------------------------
    def bucket_L(self, L: int) -> int:
        """The L bucket: next power of two of ceil(L / tp), times tp, so
        any batch size up to ``max_batch`` lands in one of
        ``log2(max_batch) + 1`` shapes and splits evenly over ``model``."""
        tp = self.ctx.tp_size
        return _next_pow2(-(-L // tp)) * tp

    def bucket_Q(self, q_items: int, Lp: int) -> int:
        """Merged-stream capacity for an L bucket: ``Lp * block_query``
        items, doubling (power-of-two blocks) only when the batch's merged
        stream overflows it."""
        cap = Lp * self.cfg.block_query
        return _next_pow2(-(-max(q_items, 1) // cap)) * cap

    def search(self, query, q_vals=None, *, options=None):
        """Public search surface. Typed form — ``search(Query(ids,
        vals), options=QueryOptions(...))`` — returns a
        ``SearchResponse``; positional ``search(q_ids, q_vals)``
        ``[L, Qn]`` arrays (pad < 0) remain as a deprecation shim
        returning the bare ``SearchResult``. Of the scheduling options
        only ``k`` applies to the resident engine."""
        from repro_torch.serve.api import (QueryStats, SearchResponse,
                                           coerce_request, truncate_k)
        q, options = coerce_request(query, q_vals, options,
                                    surface="PatternSearchEngine.search")
        res = self._search_arrays(*q.rows())
        if options is None:
            return res
        return SearchResponse(truncate_k(res, options.k), QueryStats(
            deadline_ms=options.deadline_ms, tenant=options.tenant))

    def search_typed(self, query, options=None, *,
                     _lockstep=None) -> SearchResult:
        """The raw typed surface: no wrapping, no shim warning.
        ``_lockstep`` is the mesh leader's (``distributed.lockstep``,
        passed by the serving tier): the batch goes out to the followers
        before it is scored."""
        q_ids, q_vals = query.rows()
        if _lockstep is None:
            return self._search_arrays(q_ids, q_vals)
        return _lockstep.lead({"qi": q_ids, "qv": q_vals},
                              lambda: self._search_arrays(q_ids, q_vals))

    def follow_record(self, record: dict) -> SearchResult:
        """A follower's half of one lockstep batch."""
        return self._search_arrays(record["qi"], record["qv"])

    def merged_stream(self, q_ids: np.ndarray, q_vals: np.ndarray
                      ) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
        """[L, Qn] queries (pad < 0, L >= 1) -> the host arrays a launch
        takes: (Lp, ids [Qp] int32, vals [Qp, Lp] float32, q_norms [Lp]
        float32). L pads to its bucket, the merged stream to the bucket's
        capacity with -2 pads."""
        L_ = q_ids.shape[0]
        Lp = self.bucket_L(L_)
        if Lp != L_:
            pad_i = np.full((Lp - L_, q_ids.shape[1]), -1, q_ids.dtype)
            pad_v = np.zeros((Lp - L_, q_vals.shape[1]), q_vals.dtype)
            q_ids = np.concatenate([q_ids, pad_i])
            q_vals = np.concatenate([q_vals, pad_v])
        mi, mv = kops.merge_queries(q_ids, q_vals)
        # pad the merged stream to the bucket's fixed capacity
        pad = self.bucket_Q(mi.size, Lp)
        mi = np.pad(mi, (0, pad - mi.size), constant_values=-2)
        mv = np.pad(mv, ((0, pad - mv.shape[0]), (0, 0)))
        q_norms = np.sqrt((np.where(q_vals > 0, q_vals, 0) ** 2).sum(1))
        q_norms = np.maximum(q_norms, 1e-12).astype(np.float32)
        return Lp, mi, mv, q_norms

    def _search_arrays(self, q_ids: np.ndarray,
                       q_vals: np.ndarray) -> SearchResult:
        """q_ids/q_vals: [L, Qn] (pad < 0). L is padded to its bucket."""
        L_ = q_ids.shape[0]
        if L_ == 0:
            return self.empty_result(0)
        Lp, mi, mv, q_norms = self.merged_stream(q_ids, q_vals)
        with LAUNCHES.launching():
            return self._score(L_, Lp, mi, mv, q_norms)

    def shard_topk(self, Lp, mi, mv, q_norms
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's candidates before any reduction: its row block
        scored against its Lp / tp columns of the merged stream
        (``merged_stream``'s arrays), top-k over its global doc ids:
        ([Lp / tp, k] values, ids). Uploads and launches only."""
        cfg = self.cfg
        if self.backend == "gpu_fused":
            mi_t, mv_t, qn_t = (self._upload(a) for a in (mi, mv, q_norms))
            return kops.fused_topk(
                self.f_tiles, mi_t, mv_t, qn_t, k=cfg.top_k,
                block_docs=self._block_docs,
                block_query=self.tiling.query_tile(Lp))
        cols = Lp // self.ctx.tp_size
        c0 = self.ctx.coord(self.ctx.tp_axis) * cols
        # the rank's columns, made contiguous for B1 and B2 by _upload
        mi_t, mv_t, qn_t = (self._upload(a) for a in (
            mi, mv[:, c0:c0 + cols], q_norms[c0:c0 + cols]))
        corr = kops.correlate(
            self.d_ids, self.d_vals, mi_t, mv_t, backend=self.backend,
            vocab_size=cfg.vocab_size, block_docs=cfg.block_docs,
            block_query=cfg.block_query)
        cos = kops.cosine_scores(corr, self.d_norms, qn_t)
        return topk_lib.local_topk(cos, self.d_docids, cfg.top_k)

    def _score(self, L_, Lp, mi, mv, q_norms) -> SearchResult:
        """Upload the merged stream, launch, take the top-k, reduce it
        over the mesh and read it back: the device half of
        ``_search_arrays``."""
        # optional device-stage split (DESIGN.md §8.5): with the fence
        # on, the uploads and launches are timed apart from the device
        # work they enqueue. Off by default — the synchronize serializes
        # what the .cpu() below would have overlapped.
        fence = self.obs.device_fence
        t0 = time.perf_counter() if fence else 0.0
        v, i = self.shard_topk(Lp, mi, mv, q_norms)
        ctx, k = self.ctx, self.cfg.top_k
        if ctx.mesh is not None:
            # reduce across the corpus-shard (K) axes — the paper's
            # report path — then put the columns back together
            for axis in ctx.dp_axes:
                v, i = topk_lib.tree_topk(v, i, k, ctx, axis)
            v = compat.all_gather_axis(v, ctx, ctx.tp_axis, dim=0)
            i = compat.all_gather_axis(i, ctx, ctx.tp_axis, dim=0)
        if self.backend == "gpu_fused":
            n_docs = self.f_tiles.shape[0] * self._block_docs
        else:
            n_docs = self.d_ids.shape[0]
        if fence:
            t1 = time.perf_counter()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t2 = time.perf_counter()
            reg = self.obs.registry
            reg.histogram("stage_ms", stage="score_dispatch").observe(
                (t1 - t0) * 1e3)
            reg.histogram("stage_ms", stage="score_device").observe(
                (t2 - t1) * 1e3)
        key = (Lp // ctx.tp_size, mi.size, n_docs)
        if key not in self._launch_keys:
            self._launch_keys.append(key)
            self._trace_counter.inc()
        v = v[:L_].cpu().numpy()
        # ids come from local_topk / the fused epilogue already masked by
        # row validity, never by score finiteness
        i = i[:L_].cpu().numpy()
        return SearchResult(doc_ids=i.astype(np.int64), scores=v)

    # ------------------------------------------------------------------
    def search_streaming(self, q_ids, q_vals,
                         corpus_slabs: Iterable[SlabLike]) -> SearchResult:
        """Score a lazily-consumed sequence of corpus slabs larger than
        the card's memory, merging top-k across slabs (DESIGN.md §2).

        Each element may be a host ``Corpus`` (uploaded here) or a slab
        already on the card (``DeviceSlab`` / ``PackedSlab``). The
        iterable is never materialized."""
        best: Optional[SearchResult] = None
        it = iter(corpus_slabs)
        cur = self._as_device(next(it, None))
        if cur is None:
            return self.empty_result(q_ids.shape[0])
        while cur is not None:
            # upload the next slab before scoring the current one
            nxt = self._as_device(next(it, None))
            r = eng_search(self._with_slab(cur), q_ids, q_vals)
            best = r if best is None else _merge_results(best, r,
                                                         self.cfg.top_k)
            cur = nxt
        return best

    @property
    def compile_stats(self) -> dict:
        """Distinct launch shapes used so far: ``n_traces`` plus the (Lp,
        Qp, n_docs) key of each. The serving bound is ``n_traces <=
        log2(max_batch) + 1`` for a session whose queries stay within one
        Q capacity per L bucket."""
        return {"n_traces": len(self._launch_keys),
                "buckets": list(self._launch_keys)}

    def empty_result(self, n_queries: int) -> SearchResult:
        """The [L, k] no-result sentinel (id -1, score -inf)."""
        k = self.cfg.top_k
        return SearchResult(np.full((n_queries, k), -1, np.int64),
                            np.full((n_queries, k), -np.inf, np.float32))

    @property
    def slab_fmt(self) -> str:
        """The device-slab layout this engine scores — part of the slab
        cache key, so no backend is handed a slab of another layout:
        ``"ell"`` (``gpu``, ``torch``), ``"packed"`` (``gpu_packed``: Fig. 8
        words in the ids) and ``"fused:<block_docs>"``. The reference
        names its packed layout ``"ell"`` too (ROADMAP C11)."""
        if self.backend == "gpu_fused":
            return f"fused:{self._block_docs}"
        fmt = "packed" if self.backend == "gpu_packed" else "ell"
        if self.ctx.dp_size > 1:
            # a mesh slab holds one row block only
            fmt += f"@rows{self.ctx.dp_index}/{self.ctx.dp_size}"
        return fmt

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        # a read-only array (a rank's memory-mapped corpus) is copied:
        # torch takes no read-only numpy memory
        a = np.require(a, requirements=("C", "W"))
        with LAUNCHES.launching():
            return torch.from_numpy(a).to(self.device)

    def put_slab(self, slab: Corpus) -> SlabLike:
        """Upload a host slab. The fused backend re-encodes the rows into
        packed doc tiles (``PackedSlab``); ELL backends upload the row
        arrays (packed words for ``gpu_packed``) of this rank's block of
        the slab, padded to a multiple of the mesh rows."""
        if self.backend == "gpu_fused":
            tiles, _, _ = kfused.tile_stream(
                kfused.corpus_to_stream(slab),
                block_docs=self._block_docs, nnz_pad=self.cfg.nnz_pad,
                pad_docs_to=slab.n_docs)
            return PackedSlab(self._upload(tiles.view(np.int32)))
        if self.backend == "gpu_packed":
            # the whole slab on every rank: all raise or none does
            _require_integral_counts(slab.vals, self.backend)
        rows = self.ctx.dp_size
        n = -(-slab.n_docs // rows)
        r = self.ctx.dp_index
        slab = slab.pad_docs_to(n * rows).slice_rows(r * n, (r + 1) * n)
        ids = slab.ids
        if self.backend == "gpu_packed":
            ids = pack_ell(slab.ids, slab.vals).view(np.int32)
        return DeviceSlab(
            self._upload(ids), self._upload(slab.vals),
            self._upload(slab.norms),
            self._upload(slab.doc_ids.astype(np.int32)))

    def put_stream_slab(self, stream: np.ndarray, *,
                        pad_docs_to: Optional[int] = None
                        ) -> Tuple[PackedSlab, int, int]:
        """Fused-backend ingest straight from the Fig. 8 byte stream: a
        segment becomes device tiles with *no* host ELL decode. Returns
        ``(slab, n_docs, n_truncated)`` with the exact counts
        ``decode_to_ell`` would have reported."""
        if self.backend != "gpu_fused":
            raise ValueError("put_stream_slab is the fused-backend "
                             f"ingest; engine backend is {self.backend!r}")
        tiles, n_docs, n_trunc = kfused.tile_stream(
            stream, block_docs=self._block_docs, nnz_pad=self.cfg.nnz_pad,
            pad_docs_to=pad_docs_to)
        return PackedSlab(self._upload(tiles.view(np.int32))), n_docs, n_trunc

    def _as_device(self, slab: Optional[SlabLike]) -> Optional[SlabLike]:
        if slab is None or isinstance(slab, (DeviceSlab, PackedSlab)):
            return slab
        return self.put_slab(slab)

    def _with_slab(self, dev: SlabLike):
        eng = object.__new__(PatternSearchEngine)
        eng.__dict__.update(self.__dict__)
        if isinstance(dev, PackedSlab):
            eng.f_tiles = dev.tiles
        else:
            eng.d_ids, eng.d_vals, eng.d_norms, eng.d_docids = dev
        return eng


def eng_search(eng: PatternSearchEngine, q_ids, q_vals) -> SearchResult:
    # the streaming hot loop's internal entry: positional arrays without
    # the public shim's deprecation machinery
    return PatternSearchEngine._search_arrays(eng, q_ids, q_vals)


def _merge_results(a: SearchResult, b: SearchResult, k: int) -> SearchResult:
    """Merge two [L, k] candidate sets into the best k per row.

    Deterministic: descending score, stable within ties (a's candidates
    win over b's). Duplicate doc ids keep only their best-scoring entry,
    and no-result fillers (id < 0) never displace real candidates — any
    unfilled tail stays (-1, -inf). A verbatim copy of the reference."""
    ids = np.concatenate([a.doc_ids, b.doc_ids], axis=1).astype(np.int64)
    sc = np.concatenate([a.scores, b.scores], axis=1).astype(np.float32)
    L, M = ids.shape
    # rank every candidate by descending score; stable, so a's candidates
    # win ties against b's and order within each input is preserved
    order = np.argsort(-sc, axis=1, kind="stable")
    rid = np.take_along_axis(ids, order, axis=1)
    rsc = np.take_along_axis(sc, order, axis=1)
    # keep a candidate iff it is valid (id >= 0) and the best-ranked
    # occurrence of its doc id: stable-sorting the ranked ids groups
    # duplicates while preserving rank order inside each group
    by_id = np.argsort(rid, axis=1, kind="stable")
    sid = np.take_along_axis(rid, by_id, axis=1)
    first = np.ones((L, M), bool)
    first[:, 1:] = sid[:, 1:] != sid[:, :-1]
    keep = np.zeros((L, M), bool)
    np.put_along_axis(keep, by_id, first & (sid >= 0), axis=1)
    # compact the keepers leftward in rank order into the [L, k] output
    pos = np.cumsum(keep, axis=1) - 1
    out_i = np.full((L, k), -1, np.int64)
    out_s = np.full((L, k), -np.inf, np.float32)
    rows, cols = np.nonzero(keep & (pos < k))
    out_i[rows, pos[rows, cols]] = rid[rows, cols]
    out_s[rows, pos[rows, cols]] = rsc[rows, cols]
    return SearchResult(out_i, out_s)
