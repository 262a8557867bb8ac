"""Serving layer of the search engine: the typed Query/QueryOptions API,
admission control, the EDF micro-batcher and the coalescing
SearchService (DESIGN.md §7, §7.3). The port of ``repro.serve`` without
replica hedging, which comes with the cluster router that calls it
(ROADMAP queue A5)."""
from repro_torch.serve.admission import AdmissionController, TokenBucket
from repro_torch.serve.api import (DeadlineExceeded, OverloadError, Query,
                                   QueryOptions, QueryStats, SearchResponse)
from repro_torch.serve.batcher import BatcherStats, MicroBatcher
from repro_torch.serve.search_service import SearchService

__all__ = [
    "AdmissionController", "BatcherStats", "DeadlineExceeded",
    "MicroBatcher", "OverloadError", "Query", "QueryOptions", "QueryStats",
    "SearchResponse", "SearchService", "TokenBucket",
]
