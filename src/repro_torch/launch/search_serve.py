"""Concurrent-serving launcher: closed-loop load generator against the
micro-batching SearchService (DESIGN.md §7), on the CUDA card.

N client threads each submit one query at a time and wait for its
result (closed loop), so offered load scales with concurrency the way
a fleet of blocking callers does. Reports per-query p50/p99 latency,
aggregate QPS, batch occupancy and the engine's launch shapes.

    PYTHONPATH=src python -m repro_torch.launch.search_serve \\
        --n-docs 20000 --clients 16 --requests 32 --max-batch 8

    # one-query-at-a-time baseline for the coalescing speedup:
    PYTHONPATH=src python -m repro_torch.launch.search_serve --serial \\
        --n-docs 20000 --clients 16 --requests 32

Add ``--store PATH`` to serve an existing FlashStore through a
FlashSearchSession, or ``--cluster PATH`` to serve a sharded store
(DESIGN.md §5) through a FlashClusterSession, instead of a synthesized
resident corpus. With either, ``--ingest N`` additionally runs a
closed-loop writer thread that appends N fresh documents through the
live-ingestion tier (WAL ->
memtable -> delta segments, DESIGN.md §6) *while* the query clients run
— the serving-under-writes scenario — and reports appends/sec plus
seal/compaction counts. ``--cache-mb`` sizes the slab cache on the card
(0 disables it). On a cluster, ``--hedge-percentile P`` arms replica
hedging and ``--allow-partial`` lets a query that hits ``--deadline-ms``
return the merged top-k of the shards that answered, flagged partial.

Observability (DESIGN.md §8): every target serves under one ``Obs``
bundle and prints the same post-run summary. ``--metrics-out PATH``
dumps the registry in Prometheus text format (plus
``PATH.traces.json`` when tracing); ``--trace-sample N`` samples every
Nth query into a QueryTrace and prints the last one;
``--device-fence`` splits the engine's score into dispatch vs device
time (``torch.cuda.synchronize``). ``--telemetry-port PORT`` serves the
live plane (/metrics, /healthz, /slo, /debug/traces; DESIGN.md §8.5) for
the run, with the stock SLOs of ``--slo-ms`` and ``--slo-target``;
``--profile-dir DIR`` arms /debug/profile, a ``torch.profiler`` capture
of every thread and, on the card, its kernels.

The port of ``repro.launch.search_serve``. ``--device`` defaults to the
card; ``--device cpu`` runs the kernels' plain versions. ``--backend``
takes ``gpu`` (the default), ``gpu_packed`` or ``torch``. ``main``
returns the run's numbers as a dict (with ``--telemetry-port``, the
server's URL and each objective's final state).
"""
import argparse
import threading
import time

import numpy as np

from repro_torch.configs.paper_search import SearchConfig
from repro_torch.core import corpus as corpus_lib
from repro_torch.core.engine import PatternSearchEngine
from repro_torch.device import resolve
from repro_torch.obs import Obs
from repro_torch.obs.export import (render_summary, render_trace,
                                    write_metrics, write_traces)
from repro_torch.serve import (DeadlineExceeded, HedgePolicy, OverloadError,
                               Query, QueryOptions, SearchService)


def run_clients(n_clients, n_requests, do_query):
    """Closed loop: each thread issues its requests back-to-back.
    Returns (per-query latencies sec, wall time sec)."""
    lats = [[] for _ in range(n_clients)]
    errors = []

    def client(tid):
        rng = np.random.default_rng(1000 + tid)
        try:
            for _ in range(n_requests):
                t0 = time.perf_counter()
                do_query(rng)
                lats[tid].append(time.perf_counter() - t0)
        except Exception as e:           # surface, don't hang the join
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return np.concatenate([np.asarray(l) for l in lats]), wall


def report(tag, lats, wall):
    n = lats.size
    print(f"[{tag}] {n} queries in {wall:.2f}s -> {n / wall:.1f} QPS | "
          f"latency p50 {np.percentile(lats, 50) * 1e3:.1f} ms  "
          f"p99 {np.percentile(lats, 99) * 1e3:.1f} ms  "
          f"mean {lats.mean() * 1e3:.1f} ms")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=20_000)
    ap.add_argument("--vocab", type=int, default=50_000)
    ap.add_argument("--avg-nnz", type=int, default=60)
    ap.add_argument("--nnz-pad", type=int, default=64)
    ap.add_argument("--query-nnz", type=int, default=48)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--backend", choices=["torch", "gpu", "gpu_packed"],
                    default="gpu")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions)")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--requests", type=int, default=32,
                    help="requests per client (closed loop)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--serial", action="store_true",
                    help="bypass the coalescer: searcher.search per query "
                         "under a lock (the one-at-a-time baseline)")
    # scheduling plane (DESIGN.md §7.3): deadlines and admission
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-query latency budget: the EDF batcher "
                         "flushes early to meet it and drops expired "
                         "requests (DeadlineExceeded) before scoring")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="admission bound on queued+scoring requests; "
                         "beyond it submits shed with OverloadError")
    ap.add_argument("--tenant-qps", type=float, default=None,
                    help="per-tenant token-bucket quota (tokens/s); "
                         "over-quota submits shed with OverloadError")
    ap.add_argument("--allow-partial", action="store_true",
                    help="consent to best-effort gathers: a cluster "
                         "query that hits --deadline-ms returns the "
                         "merged top-k of the responsive shards, "
                         "flagged partial")
    ap.add_argument("--hedge-percentile", type=float, default=None,
                    metavar="P",
                    help="arm replica hedging on the cluster: fire the "
                         "next replica once a shard attempt outlives "
                         "the rolling-window P-quantile of shard "
                         "latency (e.g. 0.95; needs --cluster with "
                         "replicas >= 2)")
    # approximate tier (DESIGN.md §15): candidate generation + re-rank
    ap.add_argument("--mode", choices=["exact", "approx", "auto"],
                    default="exact",
                    help="scoring tier for --store/--cluster: exact "
                         "scans every surviving slab (default), approx "
                         "takes the posting-candidate + exact-re-rank "
                         "path, auto picks by corpus size")
    ap.add_argument("--recall-target", type=float, default=None,
                    metavar="R",
                    help="approx-tier recall@k goal in (0, 1]; sizes "
                         "the candidate pool per query when "
                         "--candidates is not given")
    ap.add_argument("--candidates", type=int, default=None, metavar="C",
                    help="explicit per-segment top-C candidate pool "
                         "for the approx tier (wins over "
                         "--recall-target)")
    ap.add_argument("--memo", type=int, default=0, metavar="N",
                    help="recurrent-query memo cache: keep the last N "
                         "results keyed by normalized query fingerprint "
                         "(0 = off; invalidated on any store mutation)")
    tgt = ap.add_mutually_exclusive_group()
    tgt.add_argument("--store", help="serve this FlashStore path through a "
                                     "FlashSearchSession")
    tgt.add_argument("--cluster", help="serve this sharded-store path "
                                       "through a FlashClusterSession")
    ap.add_argument("--ingest", type=int, default=0, metavar="N",
                    help="append N synthesized documents through the "
                         "live write path while the clients run "
                         "(requires --store or --cluster)")
    ap.add_argument("--seal-docs", type=int, default=256,
                    help="memtable seal threshold for --ingest")
    ap.add_argument("--cache-mb", type=float, default=None,
                    help="slab cache budget on the card in MB for "
                         "--store/--cluster (default: the storage tier's "
                         "default budget; 0 disables the cache)")
    ap.add_argument("--metrics-out", metavar="PATH",
                    help="write the metrics registry in Prometheus text "
                         "format here after the run (and the retained "
                         "trace trees to PATH.traces.json when "
                         "--trace-sample is on)")
    ap.add_argument("--trace-sample", type=int, default=0, metavar="N",
                    help="sample every Nth query into a QueryTrace "
                         "(0 = tracing off, the default)")
    ap.add_argument("--slow-ms", type=float, default=250.0,
                    help="slow-query log threshold for the summary")
    ap.add_argument("--telemetry-port", type=int, default=None,
                    metavar="PORT",
                    help="serve the live telemetry plane (/metrics, "
                         "/healthz, /slo, /debug/traces — DESIGN.md "
                         "§8.5) on 127.0.0.1:PORT for the run's "
                         "duration (0 picks a free port)")
    ap.add_argument("--slo-ms", type=float, default=250.0,
                    help="latency-SLO threshold for the telemetry "
                         "plane's stock objectives")
    ap.add_argument("--slo-target", type=float, default=0.99,
                    help="latency-SLO good fraction target")
    ap.add_argument("--profile-dir", metavar="DIR",
                    help="arm /debug/profile: GET it to capture a "
                         "torch.profiler trace into DIR (needs "
                         "--telemetry-port)")
    ap.add_argument("--device-fence", action="store_true",
                    help="synchronize after the score dispatch so "
                         "stage_ms splits score into dispatch vs device "
                         "time — measurement mode, adds a sync")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.ingest and not (args.store or args.cluster):
        ap.error("--ingest needs --store or --cluster (the resident "
                 "engine has no write path)")
    if (args.mode != "exact" or args.memo) \
            and not (args.store or args.cluster):
        ap.error("--mode/--memo need --store or --cluster (the resident "
                 "engine has no posting tier)")

    device = resolve(args.device)
    cfg = SearchConfig(name="serve", vocab_size=args.vocab,
                       avg_nnz_per_doc=args.avg_nnz, nnz_pad=args.nnz_pad,
                       top_k=args.top_k)
    cache_bytes = None if args.cache_mb is None \
        else int(args.cache_mb * 1e6)
    # one Obs bundle for the whole process: every target publishes into
    # the same registry, so the post-run summary is target-agnostic
    obs = Obs(trace_sample=args.trace_sample, slow_ms=args.slow_ms,
              device_fence=args.device_fence)
    if args.store:
        from repro_torch.storage import FlashSearchSession, FlashStore
        store = FlashStore.open(args.store)
        searcher = FlashSearchSession(store, cfg, device, args.backend,
                                      cache_bytes=cache_bytes, obs=obs,
                                      mode=args.mode,
                                      memo_entries=args.memo)
        corpus = store.scan_corpus(cfg.nnz_pad, strict=False)
        print(f"[serve] store {args.store}: {store.n_docs} docs / "
              f"{store.n_segments} segments")
    elif args.cluster:
        from repro_torch.cluster import FlashClusterSession, ShardedStore
        cstore = ShardedStore.open(args.cluster)
        hedge = (HedgePolicy(percentile=args.hedge_percentile)
                 if args.hedge_percentile is not None else None)
        searcher = FlashClusterSession(cstore, cfg, device=device,
                                       backend=args.backend,
                                       cache_bytes=cache_bytes, obs=obs,
                                       hedge_policy=hedge, mode=args.mode,
                                       memo_entries=args.memo)
        corpus = cstore.scan_corpus(cfg.nnz_pad, strict=False)
        print(f"[serve] cluster {args.cluster}: {cstore.n_shards} shards x "
              f"{cstore.replicas} replicas, {cstore.n_docs} docs")
    else:
        print(f"[serve] synthesizing {args.n_docs} docs "
              f"(vocab {args.vocab}, ~{args.avg_nnz} nnz/doc)...")
        corpus = corpus_lib.synthesize(args.n_docs, args.vocab, args.avg_nnz,
                                       args.nnz_pad, seed=args.seed)
        searcher = PatternSearchEngine(corpus, cfg, device,
                                       backend=args.backend, obs=obs)

    # live telemetry plane (DESIGN.md §8.5): HTTP thread on the shared
    # Obs bundle, up for the whole run so an operator (or the cluster
    # stress test) can scrape mid-load
    telemetry = None
    slo_monitor = None
    if args.telemetry_port is not None:
        from repro_torch.obs.server import (TelemetryServer,
                                            register_searcher_health)
        from repro_torch.obs.slo import SLOMonitor, default_slos
        surface = ("cluster" if args.cluster
                   else "store" if args.store else "serve")
        slo_monitor = SLOMonitor(obs, default_slos(
            surface, latency_ms=args.slo_ms,
            latency_target=args.slo_target))
        telemetry = TelemetryServer(obs, port=args.telemetry_port,
                                    slo_monitor=slo_monitor,
                                    profile_dir=args.profile_dir,
                                    device=device)
        register_searcher_health(telemetry, searcher)
        print(f"[serve] telemetry: {telemetry.url('/metrics')}  "
              f"{telemetry.url('/healthz')}  {telemetry.url('/slo')}")

    def draw_query(rng):
        qi, qv = corpus_lib.make_query(corpus, int(rng.integers(corpus.n_docs)),
                                       args.query_nnz)
        return qi, qv

    writer_state = {"done": 0, "wall": 0.0}
    writer_thread = None
    if args.ingest:
        searcher.enable_ingest(seal_docs=args.seal_docs)
        # sample from the *store's* vocab, not the CLI default — the
        # session allows store.vocab_size < cfg.vocab_size, and appends
        # reject word ids beyond the store's range
        vocab = searcher.store.vocab_size
        next_id = int(corpus.doc_ids.max()) + 1 if corpus.n_docs else 0

        def writer():
            # closed loop: one append at a time, back-to-back, racing
            # the query clients — every search snapshots mid-stream
            rng = np.random.default_rng(args.seed + 7)
            nnz = min(args.avg_nnz, vocab)
            t0 = time.perf_counter()
            try:
                for i in range(args.ingest):
                    pairs = [(int(w), int(rng.integers(1, 30))) for w in
                             rng.choice(vocab, nnz, replace=False)]
                    searcher.append(next_id + i, pairs)
                    writer_state["done"] = i + 1
            except Exception as e:           # surfaced after join, like
                writer_state["error"] = e    # the query clients' errors
            finally:
                writer_state["wall"] = time.perf_counter() - t0

        writer_thread = threading.Thread(target=writer, name="ingest-writer")

    def warm_buckets(max_l):
        """Launch every L-bucket shape up front (and build the kernels)
        so the measured window is steady-state."""
        rng = np.random.default_rng(args.seed)
        L = 1
        while L <= max_l:
            qs = [draw_query(rng) for _ in range(L)]
            searcher.search(Query(np.stack([q[0] for q in qs]),
                                  np.stack([q[1] for q in qs])))
            L *= 2

    # the per-query scheduling contract (None = legacy FIFO/unbounded);
    # --recall-target/--candidates ride per query so the session default
    # mode can stay exact while clients opt into the approx tier
    q_opts = None
    if (args.deadline_ms is not None or args.allow_partial
            or args.hedge_percentile is not None
            or args.recall_target is not None
            or args.candidates is not None):
        q_opts = QueryOptions(deadline_ms=args.deadline_ms,
                              allow_partial=args.allow_partial,
                              recall_target=args.recall_target,
                              candidates=args.candidates)
    sched = {"shed": 0, "expired": 0}
    sched_lock = threading.Lock()
    out = {"target": ("store" if args.store else "cluster" if args.cluster
                      else "resident"),
           "backend": args.backend, "device": str(device), "obs": obs}

    if args.serial:
        lock = threading.Lock()          # searchers serve one call at a time

        def do_query(rng):
            qi, qv = draw_query(rng)
            with lock:
                searcher.search(Query(qi[None], qv[None]))

        warm_buckets(1)
        if writer_thread is not None:
            writer_thread.start()
        lats, wall = run_clients(args.clients, args.requests, do_query)
        report("serial", lats, wall)
    else:
        svc = SearchService(searcher, max_batch=args.max_batch,
                            max_delay_ms=args.max_delay_ms,
                            max_pending=args.max_pending,
                            tenant_qps=args.tenant_qps)

        def do_query(rng):
            qi, qv = draw_query(rng)
            try:
                svc.submit(Query(qi, qv), options=q_opts).result()
            except OverloadError:        # shed at the door — counted,
                with sched_lock:         # not fatal: backpressure is
                    sched["shed"] += 1   # the feature under test
            except DeadlineExceeded:
                with sched_lock:
                    sched["expired"] += 1

        warm_buckets(args.max_batch)
        if writer_thread is not None:
            writer_thread.start()
        lats, wall = run_clients(args.clients, args.requests, do_query)
        report(f"coalesced x{args.max_batch}", lats, wall)
        st = svc.stats
        print(f"  batches {st.n_batches}  mean occupancy "
              f"{st.mean_occupancy:.2f}  flushes {st.flushes}")
        if svc.admission is not None or q_opts is not None:
            n_total = args.clients * args.requests
            print(f"  scheduling: {sched['shed']} shed "
                  f"({100 * sched['shed'] / max(n_total, 1):.1f}%) "
                  f"{st.flushes.get('deadline', 0)} deadline flushes, "
                  f"{st.n_expired} expired; "
                  f"by reason {svc.shed_counts()}")
        svc.close()
        out.update(batches=st.n_batches, mean_occupancy=st.mean_occupancy,
                   flushes=dict(st.flushes), expired=st.n_expired,
                   shed=sched["shed"])
    out.update(queries=int(lats.size), wall_s=wall, qps=lats.size / wall,
               p50_ms=float(np.percentile(lats, 50) * 1e3),
               p99_ms=float(np.percentile(lats, 99) * 1e3))
    if writer_thread is not None:
        writer_thread.join()                 # let a slow writer finish
        if "error" in writer_state:
            raise writer_state["error"]
        done, w_wall = writer_state["done"], writer_state["wall"]
        print(f"  ingest: {done} docs appended in {w_wall:.2f}s "
              f"-> {done / max(w_wall, 1e-9):.0f} appends/s under load")
        pipes = [searcher.ingest] if args.store \
            else searcher.router.ingest_pipelines()
        seals = sum(p.stats.seals for p in pipes)
        folds = sum(p.stats.compactions for p in pipes)
        tail = sum(len(p.memtable) for p in pipes)
        print(f"  ingest: {seals} seal(s), {folds} background fold(s); "
              f"memtable tail {tail} docs")
        qi, qv = corpus_lib.make_query(corpus, 0, args.query_nnz)
        searcher.search(Query(qi[None], qv[None]))  # post-run sanity pass
        st = searcher.last_stats
        print(f"  post-ingest store: {st.docs_scored} docs scored "
              f"(snapshot incl. memtable)")
        out.update(appended=done, appends_per_s=done / max(w_wall, 1e-9),
                   seals=seals, folds=folds, memtable_tail=tail,
                   post_docs_scored=st.docs_scored)
    # unified post-run block (DESIGN.md §8.3): one summary whichever
    # target served — resident engine, store session, or cluster
    print(render_summary(searcher, obs, slo_monitor=slo_monitor))
    if args.cluster:
        router = searcher.router
        down = sum(not ok for row in router.health() for ok in row)
        print(f"router lifetime: {router.failovers} replicas "
              f"failed over, {down} out of rotation")
        # read without creating: an unused counter must not show up in
        # --metrics-out, whose names are the reference's
        counts = {name: int(m.value) for name, _, kind, m
                  in obs.registry.items() if kind == "counter"}
        out.update(failovers=router.failovers,
                   hedges=counts.get("cluster_hedges_total", 0),
                   hedge_wins=counts.get("cluster_hedge_wins_total", 0),
                   partial=counts.get("cluster_partial_total", 0))
    if args.memo:
        ms = searcher.memo_stats
        total = ms.hits + ms.misses
        print(f"memo cache: {ms.hits}/{total} hits "
              f"({100 * ms.hits / max(total, 1):.1f}%), "
              f"{ms.entries} entries, {ms.evictions} evicted")
    if args.trace_sample:
        print("last sampled trace:")
        print(render_trace(getattr(searcher, "last_trace", None)
                           or obs.tracer.last_trace))
    if args.metrics_out:
        write_metrics(obs, args.metrics_out)
        print(f"metrics -> {args.metrics_out}")
        if args.trace_sample:
            n = write_traces(obs, args.metrics_out + ".traces.json")
            print(f"traces  -> {args.metrics_out}.traces.json ({n} trace(s))")
    if telemetry is not None:
        out.update(telemetry_url=telemetry.url("/"),
                   slo={st.name: st.to_dict()
                        for st in slo_monitor.evaluate()})
        telemetry.close()
    if args.store or args.cluster:
        searcher.close()
    return out


if __name__ == "__main__":
    main()
