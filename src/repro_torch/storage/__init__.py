"""Flash storage tier: persistent segment store with in-storage filtering,
async prefetch, and the query planner + device slab cache
(DESIGN.md §3–§4). The port of ``repro.storage``, with the same exports;
its sessions score on the card (``FlashSearchSession``)."""
from repro_torch.storage.filter import (BitmapFilter, BloomFilter, QueryProbe,
                                  build_filter, from_meta)
from repro_torch.storage.memo import MemoCache, MemoStats, query_fingerprint
from repro_torch.storage.plan import (MODE_APPROX, MODE_AUTO, MODE_EXACT, MODES,
                                Planner, PlanStep, QueryPlan, execute_plan)
from repro_torch.storage.postings import PostingIndex, gather_rows
from repro_torch.storage.prefetch import Prefetcher
from repro_torch.storage.segment import Segment, read_footer, write_segment
from repro_torch.storage.session import FlashSearchSession, SearchStats
from repro_torch.storage.slabcache import (CacheStats, SlabCache,
                                     DEFAULT_CACHE_BYTES)
from repro_torch.storage.store import (FlashStore, StoreFormatError, StoreStats)

__all__ = [
    "BitmapFilter", "BloomFilter", "QueryProbe", "build_filter", "from_meta",
    "MemoCache", "MemoStats", "query_fingerprint",
    "MODE_APPROX", "MODE_AUTO", "MODE_EXACT", "MODES",
    "Planner", "PlanStep", "QueryPlan", "execute_plan",
    "PostingIndex", "gather_rows",
    "Prefetcher", "Segment", "read_footer", "write_segment",
    "FlashSearchSession", "SearchStats",
    "CacheStats", "SlabCache", "DEFAULT_CACHE_BYTES",
    "FlashStore", "StoreFormatError", "StoreStats",
]
