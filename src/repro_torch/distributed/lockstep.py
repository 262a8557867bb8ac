"""Lockstep: one rank leads each batch of a mesh search, the others follow.

The engine's collectives pair up only when every rank scores the same
batch over the same view, with the same buckets and launch sequence. The
serving tier (``serve.search_service``) and the write path
(``ingest.pipeline``) run on one process's threads and clock, so on a
mesh rank 0 (the leader) alone takes requests, forms the coalesced
batches and holds the write path. Before it scores a batch it broadcasts
one record: the op, the batch's ``qi`` ``[L, Qn]`` int32 and ``qv``
``[L, Qn]`` f32, and what else the searcher needs to score it the same
way (a live session adds its knobs, its memo and slab-cache verdicts and
its snapshot's spec). Every other rank (a follower) loops in ``follow``
on these records until the leader's stop.

The records go over a gloo group of their own (every rank's, made at a
process's first ``Leader`` or ``follow``) whose timeout is
``RECORD_TIMEOUT``: a follower waits that long for its next batch, and a
leader that exits ends the wait at once. The engine's collectives keep
their own groups and timeouts.

Every batch ends, on every rank, with a one-element all-reduce over the
world's group, under the timeout the world was made with: the max of the
ranks' failure flags. It keeps the leader's snapshot registered (its
files safe from the compactor's GC) until every follower is done with
the batch. A failure that leaves the ranks' collectives paired is
contained: a batch that raises on every rank before it scores (a knob
the planner refuses), or on any rank after its last collective, fails on
every rank, and the loop goes on. Any other failure (one rank raising
before or while it scores, while the others reduce) breaks the lockstep
for good: the ranks' collectives stop pairing and fail at their groups'
timeouts (a follower's at the world's, in the reduction; a rank still
in the engine's at its axis group's, which a DeviceMesh sets to
torch.distributed's default unless it is built with one), or at once
when a rank's process exits. From then on the leader refuses every
batch and each follower's ``follow`` has raised.

The reference needs none of this: its one controller drives every device
of its mesh, so its service and its write path are in lockstep already.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import threading
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.meshctx import MeshCtx

LEADER, FOLLOWER = "leader", "follower"
BATCH, STOP = "batch", "stop"
# how long a follower waits for its next record: a service may idle
RECORD_TIMEOUT = datetime.timedelta(days=30)

log = logging.getLogger(__name__)
_records: Optional[tuple] = None    # (the world's group, the records' group)


class BatchFailed(RuntimeError):
    """A batch raised on another rank; it fails on this one too."""


@dataclasses.dataclass
class LockstepStats:
    records: int = 0          # records sent (leader) or received (follower)
    batches: int = 0          # batches scored, failed ones included
    failed: int = 0           # batches that raised on some rank
    broadcast_s: float = 0.0  # host seconds in record broadcasts (a
                              # follower's include its wait for the leader)
    agree_s: float = 0.0      # host seconds in the end-of-batch reductions


def role(ctx: Optional[MeshCtx]) -> Optional[str]:
    """``LEADER`` on the world's rank 0 of a mesh of more than one rank,
    ``FOLLOWER`` on its other ranks, ``None`` off a mesh (one device)."""
    if ctx is None or ctx.mesh is None or ctx.size == 1:
        return None
    return LEADER if dist.get_rank() == 0 else FOLLOWER


def _records_group():
    """The records' gloo group; every rank makes it together, once per
    world."""
    global _records
    world = dist.group.WORLD
    if _records is None or _records[0] is not world:
        _records = (world, dist.new_group(backend="gloo",
                                          timeout=RECORD_TIMEOUT))
    return _records[1]


class _Wire:
    """The lockstep's two collectives as one rank sees them."""

    def __init__(self, ctx: MeshCtx):
        if dist.get_world_size() != ctx.size:
            raise ValueError(
                f"a lockstep needs the mesh to span the world: the mesh has "
                f"{ctx.size} ranks, the world {dist.get_world_size()}")
        self.records = _records_group()
        on_card = "nccl" in dist.get_backend()
        self.device = torch.device(ctx.device) if on_card else torch.device(
            "cpu")
        self.stats = LockstepStats()
        self.broken: Optional[BaseException] = None

    def broadcast(self, record: Optional[dict]) -> dict:
        box = [record]
        t0 = time.perf_counter()
        try:
            dist.broadcast_object_list(box, src=0, group=self.records)
        except BaseException as e:
            self.broken = e
            raise
        self.stats.broadcast_s += time.perf_counter() - t0
        self.stats.records += 1
        return box[0]

    def step(self, score: Callable[[], Any]):
        """Run ``score`` and agree with every rank on the batch's outcome:
        (its result or None, its own error or None, whether any rank
        failed)."""
        out = err = None
        try:
            out = score()
        except Exception as e:          # reported to every rank below
            err = e
        flag = torch.tensor([int(err is not None)], dtype=torch.int32,
                            device=self.device)
        t0 = time.perf_counter()
        try:
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        except BaseException as e:
            self.broken = e
            raise
        self.stats.agree_s += time.perf_counter() - t0
        self.stats.batches += 1
        failed = bool(flag.item())
        self.stats.failed += failed
        return out, err, failed


class Leader:
    """Rank 0's side: ``lead`` broadcasts a batch's record and scores it,
    ``close`` releases the followers. Thread-safe; every record and every
    batch's collectives go out under one lock, in one order."""

    def __init__(self, ctx: MeshCtx):
        self._wire = _Wire(ctx)
        self._lock = threading.Lock()
        self._closed = False

    @property
    def stats(self) -> LockstepStats:
        return self._wire.stats

    def lead(self, record: dict, score: Callable[[], Any]):
        """Broadcast ``record`` as a batch, run ``score`` and return what
        it returned. Raises its error, or ``BatchFailed`` if only another
        rank failed the batch."""
        with self._lock:
            self._check()
            self._wire.broadcast(dict(record, op=BATCH))
            out, err, failed = self._wire.step(score)
        if err is not None:
            raise err
        if failed:
            raise BatchFailed("a follower rank failed this batch")
        return out

    def close(self):
        """Stop the followers' loops (idempotent)."""
        with self._lock:
            if not self._closed and self._wire.broken is None:
                try:
                    self._wire.broadcast({"op": STOP})
                except Exception:
                    log.exception("lockstep: the stop record failed")
            self._closed = True

    def _check(self):
        if self._closed:
            raise RuntimeError("the lockstep is closed")
        if self._wire.broken is not None:
            raise RuntimeError(f"the lockstep broke on "
                               f"{self._wire.broken!r}") from self._wire.broken


def follow(ctx: Optional[MeshCtx], score: Callable[[dict], Any]
           ) -> LockstepStats:
    """A follower's loop: ``score(record)`` for every batch the leader
    broadcasts, until its stop. A batch that fails on every rank is
    logged and counted, and the loop goes on; a broken lockstep raises.
    Returns this rank's counts."""
    if role(ctx) != FOLLOWER:
        raise RuntimeError(
            "follow() runs on a follower: a rank other than 0 of a mesh of "
            "more than one rank")
    wire = _Wire(ctx)
    while True:
        record = wire.broadcast(None)
        if record["op"] == STOP:
            return wire.stats
        _, err, failed = wire.step(lambda: score(record))
        if failed:
            log.warning("lockstep: batch %d failed (%r on this rank)",
                        wire.stats.batches, err)
