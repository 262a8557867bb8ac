"""Sharded multi-slice cluster tier: partitioned FlashStores, replica
failover, and scatter/gather top-k behind one serving surface
(DESIGN.md §5). The port of ``repro.cluster``, with the same exports;
its shard sessions score on the card."""
from repro_torch.cluster.partition import (HashPartitioner, Partitioner,
                                           RangePartitioner, from_spec,
                                           make_partitioner)
from repro_torch.cluster.router import (ClusterSearchError, ClusterStats,
                                        ShardRouter)
from repro_torch.cluster.session import FlashClusterSession
from repro_torch.cluster.store import (ShardedStore, build_sharded_store,
                                       rebalance)

__all__ = [
    "HashPartitioner", "Partitioner", "RangePartitioner", "from_spec",
    "make_partitioner",
    "ClusterSearchError", "ClusterStats", "ShardRouter",
    "FlashClusterSession",
    "ShardedStore", "build_sharded_store", "rebalance",
]
