"""Background slab prefetcher (DESIGN.md §3.3).

The paper hides flash latency behind compute with a prefetch predictor in
the flash interface logic; the host-scope analogue is a worker thread that
stays ``depth`` slabs ahead of the scoring loop: while the engine scores
segment i, the worker reads segment i+1 from disk (mmap page-in), decodes
it and uploads it to the card. A bounded queue provides the double
buffering — depth 2 means one slab being scored, one in flight — and
backpressure so host RAM holds at most ``depth`` decoded slabs no matter
how large the store is.

``Prefetcher`` is generic: ``items`` is any iterable, ``load`` maps an
item to the prefetched value (here: a plan step -> a slab on the card,
``storage/plan.py``). Exceptions in the worker surface in the consumer at
the failing item's position; ``close()`` stops early without draining.
A copy of ``repro.storage.prefetch``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Generic, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_DONE = object()


class _WorkerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher(Generic[T, U]):
    def __init__(self, items: Iterable[T], load: Callable[[T], U],
                 depth: int = 2, timed: bool = True):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._finished = False
        self._closed = False
        # timed=False is the Obs.disabled() floor: the blocking path
        # skips its perf_counter pair too, so a fully-disabled scan does
        # zero clock reads in this module (consumer_wait_s stays 0.0)
        self._timed = timed
        # seconds the consumer spent blocked waiting on the worker: the
        # overlap telemetry (DESIGN.md §8.2) — 0 means the prefetcher
        # fully hid the disk+decode latency behind scoring
        self.consumer_wait_s = 0.0
        self._worker = threading.Thread(
            target=self._run, args=(iter(items), load), daemon=True,
            name="slab-prefetch")
        self._worker.start()

    def _put(self, obj) -> bool:
        """Blocking put that aborts on close(); True if delivered."""
        while not self._stop.is_set():
            try:
                self._q.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it: Iterator[T], load: Callable[[T], U]):
        try:
            for item in it:
                if self._stop.is_set():
                    return
                if not self._put(load(item)):
                    return
            self._put(_DONE)
        except BaseException as e:  # surfaced at the consumer
            self._put(_WorkerError(e))

    def __iter__(self) -> Iterator[U]:
        return self

    def __next__(self) -> U:
        if self._finished:          # after _DONE or a worker error the
            raise StopIteration     # stream is over; never block again
        try:                        # fast path: slab already queued —
            v = self._q.get_nowait()   # no clock reads on full overlap
        except queue.Empty:
            if self._timed:
                t0 = time.perf_counter()
                v = self._q.get()
                self.consumer_wait_s += time.perf_counter() - t0
            else:
                v = self._q.get()
        if v is _DONE:
            self._finished = True
            raise StopIteration
        if isinstance(v, _WorkerError):
            self._finished = True
            raise v.exc
        return v

    def close(self):
        """Stop the worker and discard queued (possibly unconsumed)
        slabs. Idempotent: a plan that finishes with items still queued
        — e.g. every segment was a cache hit and the engine drained the
        stream early — can be closed again by an outer finally without
        re-joining or re-draining."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._drain()
        self._worker.join(timeout=5)
        self._drain()     # anything the worker enqueued while we joined

    def _drain(self):
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
