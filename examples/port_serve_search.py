"""Concurrent query serving on the PyTorch/CUDA port: 16 blocking
clients, one engine on the card, coalesced micro-batches (DESIGN.md §7)
— driven through the typed Query / QueryOptions request API
(DESIGN.md §7.3).

Each "user" thread submits single queries and blocks on its Future —
the closed-loop shape of real traffic. The SearchService coalesces
whatever is pending into one L-column batch per corpus pass, so
throughput scales with concurrency while every client still gets
exactly the result a serial engine search would have returned. Passing
QueryOptions opts a request into the scheduling plane: it gets a
latency budget (the EDF batcher flushes early to honor it), a tenant
for admission accounting, and a SearchResponse back whose QueryStats
report the queue wait the scheduler actually charged it. The same run
as ``examples/serve_search.py``, on the port.

    PYTHONPATH=src python examples/port_serve_search.py [--device cpu]

``--device`` defaults to the CUDA card (and fails without one); on the
CPU the kernels' plain versions score.
"""
import argparse
import threading
import time

import numpy as np

from repro_torch.configs.paper_search import SearchConfig
from repro_torch.core import corpus as corpus_lib
from repro_torch.core.engine import PatternSearchEngine
from repro_torch.serve import Query, QueryOptions, SearchService


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--backend", default="gpu",
                    choices=["gpu", "gpu_packed", "gpu_fused", "torch"])
    args = ap.parse_args(argv)
    cfg = SearchConfig(name="serve-demo", vocab_size=30_000,
                       avg_nnz_per_doc=50, nnz_pad=64, top_k=5)
    n_docs, n_clients, per_client = 8_000, 16, 16
    print(f"synthesizing {n_docs} docs, serving {n_clients} concurrent "
          f"clients x {per_client} queries each...")
    corpus = corpus_lib.synthesize(n_docs, cfg.vocab_size,
                                   cfg.avg_nnz_per_doc, cfg.nnz_pad, seed=0)
    engine = PatternSearchEngine(corpus, cfg, args.device, args.backend)

    # launch each power-of-two L bucket (and build the kernels) so the
    # demo numbers are steady-state
    rng = np.random.default_rng(0)
    L = 1
    while L <= 8:
        qs = [corpus_lib.make_query(corpus, int(rng.integers(n_docs)), 48)
              for _ in range(L)]
        engine.search(Query(np.stack([q[0] for q in qs]),
                            np.stack([q[1] for q in qs])))
        L *= 2

    hits = []
    waits = []
    lock = threading.Lock()
    # every request runs under a generous 250ms budget; the EDF batcher
    # flushes early rather than let one miss it
    opts = QueryOptions(deadline_ms=250.0, tenant="demo")
    with SearchService(engine, max_batch=8, max_delay_ms=2.0) as svc:
        def client(tid):
            crng = np.random.default_rng(100 + tid)
            for _ in range(per_client):
                want = int(crng.integers(n_docs))
                qi, qv = corpus_lib.make_query(corpus, want, 48)
                resp = svc.submit(Query(qi, qv),
                                  options=opts).result()  # blocking Future
                with lock:
                    hits.append(resp.doc_ids[0] == want)
                    waits.append(resp.stats.queue_wait_ms)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        st = svc.stats

    n = n_clients * per_client
    print(f"\n{n} queries in {wall:.2f}s -> {n / wall:.0f} QPS on "
          f"{engine.device} ({args.backend})")
    print(f"batches: {st.n_batches}, mean occupancy "
          f"{st.mean_occupancy:.2f}, flushes {st.flushes}")
    print(f"queue wait (scheduler-attributed): mean "
          f"{np.mean(waits):.2f} ms, max {np.max(waits):.2f} ms")
    print(f"engine launch shapes: {engine.compile_stats['n_traces']} "
          f"(L buckets)")
    assert all(hits), "every self-query must rank its own document first"
    print("OK: all self-queries returned themselves at rank 1")


if __name__ == "__main__":
    main()
