"""Typed request/response surface of the search engine."""
from repro_torch.serve.api import (Query, QueryOptions, QueryStats,
                                   SearchResponse)

__all__ = ["Query", "QueryOptions", "QueryStats", "SearchResponse"]
