"""Closed-loop clients: each thread submits its next query when the last
one returns, as a search front end's workers do.

The pattern of ``repro_torch.launch.search_serve.run_clients``, kept
here so that the yardstick does not move with the program: the clients
start together at a barrier, submit until the window closes, and each
finishes the query it has in flight. Every query's latency runs from
before ``submit`` to after its Future's result, on the client's clock.

The clients take the pool's queries in one order that no seed changes
(``ORDER_SEED``): client ``c``'s ``k``-th query is pool slot
``order(pool)[(k * clients + c) % pool]``. The seed picks the documents in
the slots (``corpusgen.pick_pool``: slot ``i`` holds a document of one
word count in every seed), so every seed sends the same sizes in the
same order, and the same sizes meet in a batch.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, List, NamedTuple

import numpy as np

ORDER_SEED = 1611_03380       # the clients' order of the pool's slots


def order(n_queries: int) -> np.ndarray:
    """The pool's slots in the order the clients take them."""
    return np.random.default_rng(ORDER_SEED).permutation(n_queries)


class Load(NamedTuple):
    answers: List[tuple]      # (query, t_submit, t_done, doc_ids, scores)
    errors: List[str]         # one line a query that raised
    attempted: int            # queries submitted
    t_start: float
    t_end: float              # the window's close (perf_counter)
    stragglers: int           # client threads still running at the join


def closed_loop(submit: Callable[[int], "object"], n_queries: int,
                n_clients: int, seconds: float,
                join_s: float = 60.0) -> Load:
    """``submit(q)`` -> a Future of query ``q`` of the pool."""
    answers: List[tuple] = []
    errors: List[str] = []
    counts = [0] * n_clients
    gate = threading.Barrier(n_clients + 1)
    clock = {}
    slots = order(n_queries)

    def client(c: int) -> None:
        gate.wait()
        t_end = clock["end"]
        for k in itertools.count():
            q = int(slots[(k * n_clients + c) % n_queries])
            t0 = time.perf_counter()
            if t0 >= t_end:
                return
            counts[c] += 1
            try:
                res = submit(q).result()
            except Exception as e:          # a failed query, not a crash
                errors.append(f"{type(e).__name__}: {e}")
                continue
            answers.append((q, t0, time.perf_counter(), res.doc_ids,
                            res.scores))

    threads = [threading.Thread(target=client, args=(c,), daemon=True,
                                name=f"searchbench-client-{c}")
               for c in range(n_clients)]
    for t in threads:
        t.start()
    t_start = time.perf_counter()
    clock["end"] = t_start + seconds
    gate.wait()
    deadline = clock["end"] + join_s
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    stragglers = sum(t.is_alive() for t in threads)
    return Load(list(answers), list(errors), sum(counts), t_start,
                clock["end"], stragglers)


LOOPS = {"closed": closed_loop}


def loop(traffic: dict) -> Callable:
    """The load generator that the traffic's ``loop`` names. A kind that
    is not here is refused, never run as another."""
    kind = traffic.get("loop")
    if kind not in LOOPS:
        raise ValueError(f"loop {kind!r}: the harness drives "
                         f"{sorted(LOOPS)} only")
    return LOOPS[kind]
