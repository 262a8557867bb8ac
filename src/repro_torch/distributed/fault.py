"""Fault tolerance & straggler mitigation policies.

TPU pods fail and straggle differently from the paper's single box: a pod
is a single SPMD failure domain (one chip down = the whole pod's step
fails), so recovery is *restart-from-checkpoint* (checkpoint/manager.py:
atomic commits + elastic resharding onto however many pods remain), and
straggler handling happens at two levels:

1. **Step level** (in-SPMD): there is no per-chip work stealing inside a
   jit step — the mitigation is deterministic, balanced partitioning
   (equal-sized shards everywhere: batch, corpus rows, experts-capacity)
   so no chip is structurally slower. The MoE capacity factor bounds the
   worst-case expert hot-spot (perfcfg / EXPERIMENTS §Perf A4).

2. **Work-queue level** (the search engine): corpora stream in slabs; a
   slab assigned to a pod that misses its deadline is requeued to another
   pod. ``SlabScheduler`` below implements the deterministic requeue with
   at-least-once semantics + idempotent top-k merging (merging the same
   slab's results twice is a no-op because top-k is idempotent on
   duplicate candidates).

For cross-pod training, the preemption hook (train/loop.py) plus
deterministic counter-based data (data/pipeline.py) make restarts exact:
any surviving pod count resumes the identical token stream.

A copy of ``repro.distributed.fault``: stdlib only, the search engine's
work-queue level.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set, Tuple


@dataclasses.dataclass
class SlabTask:
    slab_id: int
    epoch: int = 0           # bumped on requeue (paper's epoch tags)
    assigned_to: Optional[int] = None
    assigned_at: float = 0.0
    done: bool = False


class SlabScheduler:
    """Deterministic work queue for corpus slabs over worker pods with
    straggler requeue. Results merge idempotently (top-k)."""

    def __init__(self, n_slabs: int, timeout_s: float = 60.0,
                 now: Callable[[], float] = time.monotonic):
        self.tasks = [SlabTask(i) for i in range(n_slabs)]
        self.timeout_s = timeout_s
        self.now = now
        self._completed_epochs: Dict[int, int] = {}

    def next_task(self, worker: int) -> Optional[SlabTask]:
        t_now = self.now()
        # 1) unassigned slabs in deterministic order
        for t in self.tasks:
            if not t.done and t.assigned_to is None:
                t.assigned_to = worker
                t.assigned_at = t_now
                return t
        # 2) straggled slabs: requeue with a bumped epoch
        for t in self.tasks:
            if not t.done and t.assigned_to is not None and \
                    t_now - t.assigned_at > self.timeout_s and \
                    t.assigned_to != worker:
                t.epoch += 1
                t.assigned_to = worker
                t.assigned_at = t_now
                return t
        return None

    def complete(self, slab_id: int, epoch: int) -> bool:
        """Returns True if this completion is the accepted one (stale
        epochs from straggling workers are discarded — the paper's
        mispredict-discard, scheduler edition)."""
        t = self.tasks[slab_id]
        if t.done:
            return False
        if epoch != t.epoch:
            return False
        t.done = True
        self._completed_epochs[slab_id] = epoch
        return True

    @property
    def all_done(self) -> bool:
        return all(t.done for t in self.tasks)

    def pending(self) -> List[int]:
        return [t.slab_id for t in self.tasks if not t.done]
