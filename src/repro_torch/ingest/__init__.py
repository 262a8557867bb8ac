"""Live ingestion tier: WAL-backed appends, memtable + delta segments,
and online compaction under serving (DESIGN.md §6). The port of
``repro.ingest``, with the same exports and the same files on disk."""
from repro_torch.ingest.memtable import MemTable
from repro_torch.ingest.pipeline import (IngestConfig, IngestPipeline,
                                         IngestStats, Snapshot, WAL_NAME)
from repro_torch.ingest.wal import WriteAheadLog

__all__ = [
    "MemTable",
    "IngestConfig", "IngestPipeline", "IngestStats", "Snapshot", "WAL_NAME",
    "WriteAheadLog",
]
