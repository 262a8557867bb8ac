"""FlashClusterSession — FlashSearchSession's serving surface over an
N-shard cluster (DESIGN.md §5).

Drop-in at the serving layer: ``search`` / ``submit`` / ``service`` have
the single-store session's exact signatures, so `SearchService`,
`repro_torch.launch.search_serve`, and the benchmarks drive a cluster the
same way they drive one FlashStore. One coalesced batch costs one
scatter/gather pass: every shard prunes, prefetches, and scores its own
slice concurrently, and only ``[L, k]`` candidates per shard reach the
merge — the paper's "only documentIDs with high scores are reported",
at cluster scope.

A copy of ``repro.cluster.session`` for one CUDA card: ``device`` (the
card unless the caller passes ``device="cpu"``) and ``backend``
(``gpu`` by default) go through the router to every shard session.
"""
from __future__ import annotations

from typing import Optional, Union

from repro_torch.cluster.router import ClusterStats, HedgePolicy, ShardRouter
from repro_torch.cluster.store import ShardedStore
from repro_torch.configs.paper_search import SearchConfig
from repro_torch.core.engine import SearchResult
from repro_torch.device import DeviceLike
from repro_torch.serve.api import Query, QueryOptions
from repro_torch.serve.session_surface import ServingSessionMixin


class FlashClusterSession(ServingSessionMixin):
    def __init__(self, store: Union[str, ShardedStore], cfg: SearchConfig,
                 *, device: DeviceLike = None, backend: str = "gpu",
                 use_filter: bool = True,
                 prefetch_depth: int = 2,
                 max_workers: Optional[int] = None,
                 cache_bytes: Optional[int] = None,
                 obs=None, hedge_policy: Optional[HedgePolicy] = None,
                 mode: str = "exact", candidates: int = 0,
                 approx_min_docs: Optional[int] = None,
                 memo_entries: int = 0):
        """``cache_bytes`` sizes the cluster-shared device slab cache
        (DESIGN.md §4.2) every shard-replica session draws on
        (None = default budget, 0 = disabled). ``obs`` shares one
        observability bundle (DESIGN.md §8) across the router and every
        shard session; None falls back to the process default.
        ``hedge_policy`` arms replica hedging as the router default
        (DESIGN.md §7.3); per-query ``QueryOptions.hedging``
        overrides. ``mode``/``candidates``/``approx_min_docs`` set the
        approximate-tier defaults every shard session inherits (§15;
        exact by default), ``memo_entries`` sizes the cluster-shared
        recurrent-query memo cache (0 = off); per-query
        ``QueryOptions.mode/recall_target/candidates`` overrides ride
        the scatter to every shard. ``device`` defaults to the CUDA card
        and raises without one (``repro_torch.device.resolve``)."""
        if isinstance(store, str):
            store = ShardedStore.open(store)
        if store.vocab_size > cfg.vocab_size:
            # same invariant the engine and single-store session enforce
            raise ValueError(
                f"cluster vocab_size {store.vocab_size} exceeds "
                f"cfg.vocab_size {cfg.vocab_size}")
        self.store = store
        self.cfg = cfg
        self.router = ShardRouter(
            store, cfg, device=device, backend=backend,
            use_filter=use_filter,
            prefetch_depth=prefetch_depth, max_workers=max_workers,
            cache_bytes=cache_bytes, obs=obs, hedge_policy=hedge_policy,
            mode=mode, candidates=candidates,
            approx_min_docs=approx_min_docs, memo_entries=memo_entries)
        self._init_serving()

    @property
    def obs(self):
        """The cluster's shared observability bundle (DESIGN.md §8)."""
        return self.router.obs

    # ------------------------------------------------------------------
    def search(self, query, q_vals=None, *,
               options: Optional[QueryOptions] = None):
        """Global top-k over every shard (scatter/gather; see
        ShardRouter.search). Typed form — ``search(Query(ids, vals),
        options=QueryOptions(...))`` — returns a ``SearchResponse``
        with this query's scheduling stats (partial/hedged/missing
        shards); positional ``(q_ids, q_vals)`` arrays remain as a
        deprecation shim returning the bare ``SearchResult``."""
        return self.router.search(query, q_vals, options=options)

    def search_typed(self, query: Query,
                     options: Optional[QueryOptions] = None, *,
                     _span=None) -> SearchResult:
        """The raw typed surface the coalescing service dispatches to
        (no wrapping, no deprecation shim); see ShardRouter.search_typed
        for the deadline/partial/hedging contract."""
        return self.router.search_typed(query, options=options)

    # -- live ingestion (DESIGN.md §6.3) -------------------------------
    def enable_ingest(self, **knobs) -> "FlashClusterSession":
        """Attach a write path to every shard replica (each gets its own
        WAL + memtable + compactor). ``knobs`` are
        ``repro_torch.ingest.IngestConfig`` fields."""
        self.router.enable_ingest(**knobs)
        return self

    def append(self, doc_id: int, pairs) -> int:
        """Append one document to the shard that owns its id (per the
        live partition spec — rebalance-aware) on every replica; it is
        searchable by the next query. Returns the owner shard. Per-shard
        snapshot consistency is the single-store guarantee; a scatter
        batch captures each shard's snapshot independently."""
        return self.router.append(doc_id, pairs)

    def flush_ingest(self) -> int:
        """Seal every shard memtable into delta segments (do this before
        ``ShardedStore.rebalance``, which streams segments)."""
        return self.router.flush_ingest()

    @property
    def last_stats(self) -> ClusterStats:
        return self.router.last_stats

    @property
    def last_trace(self):
        """Most recent sampled cluster QueryTrace (None unless ``obs``
        samples traces)."""
        return self.router.last_trace

    @property
    def slab_cache(self):
        """The cluster-shared device slab cache (None when disabled)."""
        return self.router.slab_cache

    @property
    def cache_stats(self):
        """Lifetime slab-cache counters across every shard session —
        the same surface ``FlashSearchSession.cache_stats`` exposes."""
        return self.router.cache_stats

    @property
    def memo_stats(self):
        """Cluster-shared recurrent-query memo counters (None = off),
        mirroring ``FlashSearchSession.memo_stats``."""
        return self.router.memo_stats

    @property
    def compile_stats(self) -> dict:
        """Aggregated engine traces: total plus the per-shard worst case
        (each shard session carries its own §7.2 L-bucket bound)."""
        counts = self.router.compile_counts()
        flat = [c for row in counts for c in row]
        return {"n_traces": sum(flat),
                "per_shard": [max(row, default=0) for row in counts]}

    def _close_resources(self):
        # service/submit/close lifecycle comes from ServingSessionMixin
        # (the same surface FlashSearchSession exposes, by construction)
        self.router.close()
