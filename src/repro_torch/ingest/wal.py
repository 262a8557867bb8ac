"""Write-ahead log for single-document appends (DESIGN.md §6.1).

The flash tier's segment format is append-hostile by design: its pages,
vocabulary filter, and footer are immutable once written, which is what
makes in-storage filtering fast. Live appends therefore land in a plain
append-only log first and become segments later (seal), the classic
LSM/WAL split SpANNS applies to sparse-vector indices.

Layout (`wal.log` in the store root):

    [magic "RSPWAL1\\n"]
    [record 0 | record 1 | ...]

    record: [u32 LE payload_len][u32 LE crc32(seq || payload)]
            [u64 LE seq][payload]

The payload is one document in the Fig. 8 stream encoding
(``core/stream_format``), so the WAL reuses the exact codec the
segments persist — replay cannot drift from the segment write path.
``seq`` is monotonically increasing; the store manifest records the
highest sequence folded into durable segments (``ingest_seq``), so
replay after a crash skips records the seal already committed and a
crash between manifest swap and WAL reset cannot duplicate documents.

Torn tails are expected (a crash mid-record): ``open`` scans records,
verifies each CRC, truncates the file back to the last intact record,
and replays the survivors. A torn record loses only the single
not-yet-acknowledged document it held.

A copy of ``repro.ingest.wal``: both packages write the same bytes, and
each replays the other's log (tests/test_torch_ingest.py holds them to
it). Host work only: the log never touches the card.
"""
from __future__ import annotations

import logging
import os
import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core import stream_format

MAGIC = b"RSPWAL1\n"
_HDR = struct.Struct("<II")      # payload_len, crc32
_SEQ = struct.Struct("<Q")       # sequence number

log = logging.getLogger(__name__)

Doc = Tuple[int, Sequence[Tuple[int, int]]]


class WriteAheadLog:
    """Append-only, checksummed document log. Not thread-safe: the
    ingest pipeline serializes writers behind its write lock."""

    def __init__(self, path: str, *, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._records: List[Tuple[int, Doc]] = []
        self.last_seq = 0
        # repairs performed while opening (torn header rewrites + torn
        # tail truncations); the pipeline mirrors this into the §8
        # registry so crash-recovery events are visible fleet-wide
        self.repairs = 0
        if os.path.exists(path):
            self._records = self._scan_and_repair()
            if self._records:
                self.last_seq = self._records[-1][0]
            self._f = open(path, "ab")
        else:
            self._f = open(path, "wb")
            self._f.write(MAGIC)
            self._f.flush()

    # -- recovery ------------------------------------------------------
    def _scan_and_repair(self) -> List[Tuple[int, Doc]]:
        """Read every intact record; truncate a torn tail in place."""
        with open(self.path, "rb") as f:
            raw = f.read()
        if len(raw) < len(MAGIC):
            # crash between creating the file and the magic reaching
            # disk: a torn *header* is as expected as a torn tail —
            # rewrite as a fresh, empty log rather than bricking ingest
            log.warning("wal(%s): torn %d-byte header; rewriting empty",
                        self.path, len(raw))
            self.repairs += 1
            with open(self.path, "wb") as f:
                f.write(MAGIC)
            return []
        if raw[:len(MAGIC)] != MAGIC:
            # a full header that reads differently is a foreign file,
            # not a torn write — refuse to clobber it
            raise ValueError(f"{self.path}: bad WAL magic")
        records: List[Tuple[int, Doc]] = []
        off = len(MAGIC)
        good = off
        while off + _HDR.size <= len(raw):
            n, crc = _HDR.unpack_from(raw, off)
            body = raw[off + _HDR.size:off + _HDR.size + _SEQ.size + n]
            if len(body) < _SEQ.size + n or zlib.crc32(body) != crc:
                break                      # torn tail: stop at last good
            (seq,) = _SEQ.unpack_from(body)
            payload = np.frombuffer(body, dtype="<u4", offset=_SEQ.size)
            docs = stream_format.decode(payload)
            if len(docs) != 1:
                break                      # garbled but CRC-valid? stop
            records.append((seq, docs[0]))
            off += _HDR.size + _SEQ.size + n
            good = off
        if good < len(raw):
            log.warning("wal(%s): truncating %d torn byte(s) at offset %d",
                        self.path, len(raw) - good, good)
            self.repairs += 1
            with open(self.path, "r+b") as f:
                f.truncate(good)
        return records

    # -- write path ----------------------------------------------------
    def append(self, doc: Doc) -> int:
        """Durably (modulo ``fsync``) log one document; returns its seq."""
        seq = self.last_seq + 1
        payload = stream_format.encode([doc]).astype("<u4").tobytes()
        body = _SEQ.pack(seq) + payload
        self._f.write(_HDR.pack(len(payload), zlib.crc32(body)))
        self._f.write(body)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self.last_seq = seq
        self._records.append((seq, doc))
        return seq

    def reset(self):
        """Discard every record (they are durable in segments now). The
        caller must have committed the manifest first; ``last_seq`` keeps
        counting so sequence numbers never repeat within a process."""
        self._f.close()
        self._f = open(self.path, "wb")
        self._f.write(MAGIC)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._records = []

    # -- read path -----------------------------------------------------
    def records(self, after_seq: int = 0) -> List[Tuple[int, Doc]]:
        """(seq, doc) for every logged record with seq > ``after_seq``."""
        return [(s, d) for s, d in self._records if s > after_seq]

    @property
    def n_records(self) -> int:
        return len(self._records)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
