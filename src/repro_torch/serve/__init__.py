"""Serving layer of the search engine: the typed Query/QueryOptions API,
admission control, the EDF micro-batcher, the coalescing SearchService
and replica hedging (DESIGN.md §7, §7.3). The port of ``repro.serve``,
with the same exports."""
from repro_torch.serve.admission import AdmissionController, TokenBucket
from repro_torch.serve.api import (DeadlineExceeded, OverloadError, Query,
                                   QueryOptions, QueryStats, SearchResponse)
from repro_torch.serve.batcher import BatcherStats, MicroBatcher
from repro_torch.serve.hedging import (HedgeOutcome, HedgePolicy,
                                       SpawnExecutor, run_hedged)
from repro_torch.serve.search_service import SearchService

__all__ = [
    "AdmissionController", "BatcherStats", "DeadlineExceeded",
    "HedgeOutcome", "HedgePolicy", "MicroBatcher", "OverloadError",
    "Query", "QueryOptions", "QueryStats", "SearchResponse",
    "SearchService", "SpawnExecutor", "TokenBucket", "run_hedged",
]
