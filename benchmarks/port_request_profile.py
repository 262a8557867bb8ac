"""Where a request's time goes in the PyTorch/CUDA port, on one CUDA card.

    PYTHONPATH=src python benchmarks/port_request_profile.py [--docs N]
        [--store [--segment-docs N]] [--cluster [--shards N] [--replicas R]
        [--workers W...]] [--json]

Synthesizes the paper's full-width corpus (SearchConfig defaults, seed
0; 2^20 docs by default), builds a resident engine per backend and, for
each batch size L, times ``PatternSearchEngine.search`` on the host
clock (median and max of ``--reps`` runs; the call ends in host arrays,
so the card is done) and the host-side query preparation alone
(``merged_stream``). One more window of ``--reps`` requests runs under
``torch.profiler``: device time per kernel (and copy), per request, and
the device's idle share of that window's wall time. Prints one line per
(backend, L) and one JSON object per (backend, L) with ``--json``.

``--store`` profiles ``FlashSearchSession`` instead: the corpus is
written to a FlashStore of ``--segment-docs`` documents a segment (under
``build/store-profile`` in the checkout, removed at the end) and, per
(backend, L), one cold query (every segment a miss, decoded and uploaded
by the prefetch thread) runs under ``torch.profiler``, then ``--reps``
warm queries on the host clock (every segment a hit in the slab cache)
and a profiled window of ``--reps`` more. Each line also gives the
session's ``stage_ms`` histograms (the registry's median and mean).

``--cluster`` profiles ``FlashClusterSession`` the same way: the corpus
is written as a ShardedStore of ``--shards`` hash shards x
``--replicas`` replicas (segments of ``--segment-docs``, under
``build/cluster-profile``, removed at the end) and, per (backend, router
worker count in ``--workers``), one session takes the first L's query
cold under ``torch.profiler``, then each L warm on the host clock and in
a profiled window. The shard threads launch on the one default stream,
so the device's busy time is still one timeline; the idle share says
how much of a warm cluster query the card waits for the host.
Needs a card; it does not run on the CPU.
"""
import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.paper_search import SearchConfig
from repro_torch.core import corpus as corpus_lib
from repro_torch.core.engine import PatternSearchEngine
from repro_torch.serve import Query


def device_table(prof, n_requests):
    """(per-request device ms by kernel / copy / memset, their total).
    Only device-side events count: an op's own device time is the sum of
    its kernels', which would count twice. One stream, so the total is
    the time the card was busy."""
    rows = {ev.key: ev.self_device_time_total / 1e3 / n_requests
            for ev in prof.key_averages()
            if ev.device_type != DeviceType.CPU
            and ev.self_device_time_total > 0}
    return dict(sorted(rows.items(), key=lambda kv: -kv[1])), sum(
        rows.values())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=1 << 20)
    ap.add_argument("--L", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--backends", nargs="+",
                    default=["gpu", "gpu_packed", "gpu_fused", "torch"])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--store", action="store_true")
    ap.add_argument("--segment-docs", type=int, default=1 << 16)
    ap.add_argument("--cluster", action="store_true")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 4])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    cfg = SearchConfig(name="paper-full")
    corpus = corpus_lib.synthesize(args.docs, cfg.vocab_size,
                                   cfg.avg_nnz_per_doc, cfg.nnz_pad, seed=0)
    rng = np.random.default_rng(0)
    batches = {}
    for L in args.L:
        qs = [corpus_lib.make_query(corpus, int(i), cfg.max_query_nnz)
              for i in rng.integers(0, args.docs, L)]
        batches[L] = (np.stack([q[0] for q in qs]),
                      np.stack([q[1] for q in qs]))
    if args.store:
        return store_profile(args, card, cfg, corpus, batches, dev)
    if args.cluster:
        return cluster_profile(args, card, cfg, corpus, batches, dev)
    for backend in args.backends:
        eng = PatternSearchEngine(corpus, cfg, dev, backend)
        for L, (qi, qv) in batches.items():
            q = Query(qi, qv)
            eng.search(q)                       # first launch builds
            wall = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                eng.search(q)
                wall.append((time.perf_counter() - t0) * 1e3)
            prep = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                eng.merged_stream(qi, qv)
                prep.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    eng.search(q)
                torch.cuda.synchronize()
                window_ms = (time.perf_counter() - t0) * 1e3
            table, busy = device_table(prof, args.reps)
            idle = 1.0 - busy / (window_ms / args.reps)
            top = "; ".join(f"{k[:60]} {v:.3f}" for k, v in
                            list(table.items())[:6])
            print(f"{backend} L={L}: request median "
                  f"{statistics.median(wall):.3f} ms, max {max(wall):.3f} ms"
                  f" (n={args.reps}); host prep {statistics.median(prep):.3f}"
                  f" ms; device {busy:.3f} ms/request, idle share "
                  f"{idle:.3f} (profiled window); top device: {top}")
            if args.json:
                print(json.dumps({
                    "backend": backend, "L": L, "docs": args.docs,
                    "card": card, "request_ms_median": statistics.median(
                        wall), "request_ms_max": max(wall),
                    "n": args.reps, "host_prep_ms": statistics.median(prep),
                    "device_ms_per_request": busy, "idle_share": idle,
                    "device_ms_by_op": table}))
        del eng
        torch.cuda.empty_cache()


STAGES = ("plan", "decode", "upload", "score", "prefetch_wait", "merge")


def stages_ms(obs):
    """stage -> (median, mean, count) of the session's stage_ms, in ms."""
    out = {}
    for stage in STAGES:
        h = obs.registry.histogram("stage_ms", stage=stage).summary()
        out[stage] = (h["p50"], h["mean"], h["count"])
    return out


def store_profile(args, card, cfg, corpus, batches, dev):
    import shutil
    from pathlib import Path
    from repro_torch.obs import Obs
    from repro_torch.storage import FlashSearchSession, FlashStore, SlabCache
    root = Path(__file__).resolve().parents[1] / "build" / "store-profile"
    shutil.rmtree(root, ignore_errors=True)
    root.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    store = FlashStore.create(str(root), vocab_size=cfg.vocab_size,
                              docs_per_segment=args.segment_docs)
    store.append_corpus(corpus)
    print(f"store: {store.n_docs} docs in {store.n_segments} segments, "
          f"built in {time.perf_counter() - t0:.1f} s")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for backend in args.backends:
        for L, (qi, qv) in batches.items():
            q = Query(qi, qv)
            cache = SlabCache(8 << 30)            # each cold query misses
            cold_obs, warm_obs = Obs(), Obs()
            cold = FlashSearchSession(store, cfg, dev, backend,
                                      slab_cache=cache, obs=cold_obs)
            torch.cuda.synchronize()
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                cold.search(q)
                torch.cuda.synchronize()
                cold_ms = (time.perf_counter() - t0) * 1e3
            cold_table, cold_busy = device_table(prof, 1)
            warm = FlashSearchSession(store, cfg, dev, backend,
                                      slab_cache=cache, obs=warm_obs)
            wall = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                warm.search(q)
                wall.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    warm.search(q)
                torch.cuda.synchronize()
                window_ms = (time.perf_counter() - t0) * 1e3
            table, busy = device_table(prof, args.reps)
            idle = 1.0 - busy / (window_ms / args.reps)
            cold_st, warm_st = stages_ms(cold_obs), stages_ms(warm_obs)
            for label, st in (("cold", cold_st), ("warm", warm_st)):
                print(f"store {backend} L={L} {label} stage_ms (median, "
                      f"mean, n): " + "; ".join(
                          f"{k} {v[0]} {v[1]} {v[2]}" for k, v in st.items()))
            top = "; ".join(f"{k[:60]} {v:.3f}" for k, v in
                            list(table.items())[:6])
            cold_top = "; ".join(f"{k[:40]} {v:.3f}" for k, v in
                                 list(cold_table.items())[:4])
            print(f"store {backend} L={L}: cold {cold_ms:.1f} ms (device "
                  f"{cold_busy:.3f} ms, idle share "
                  f"{1.0 - cold_busy / cold_ms:.3f}; top {cold_top}); warm "
                  f"median {statistics.median(wall):.3f} ms, max "
                  f"{max(wall):.3f} (n={args.reps}); device {busy:.3f} "
                  f"ms/query, idle share {idle:.3f} (profiled window); top "
                  f"device: {top}")
            if args.json:
                print(json.dumps({
                    "store": True, "backend": backend, "L": L,
                    "docs": args.docs, "segment_docs": args.segment_docs,
                    "card": card, "cold_ms": cold_ms,
                    "cold_device_ms": cold_busy,
                    "cold_device_ms_by_op": cold_table,
                    "warm_ms_median": statistics.median(wall),
                    "warm_ms_max": max(wall), "n": args.reps,
                    "warm_device_ms_per_query": busy, "warm_idle_share": idle,
                    "warm_device_ms_by_op": table,
                    "cold_stage_ms": cold_st, "warm_stage_ms": warm_st,
                    "slab_cache_bytes": cache.nbytes}))
            warm.close()
            cold.close()
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)


def cluster_profile(args, card, cfg, corpus, batches, dev):
    import shutil
    from pathlib import Path
    from repro_torch.cluster import FlashClusterSession, build_sharded_store
    from repro_torch.obs import Obs
    root = Path(__file__).resolve().parents[1] / "build" / "cluster-profile"
    shutil.rmtree(root, ignore_errors=True)
    root.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    build_sharded_store(str(root), corpus=corpus, n_shards=args.shards,
                        replicas=args.replicas, policy="hash",
                        vocab_size=cfg.vocab_size,
                        docs_per_segment=args.segment_docs).close()
    print(f"cluster: {args.docs} docs as {args.shards} shards x "
          f"{args.replicas} replicas, built in "
          f"{time.perf_counter() - t0:.1f} s")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for backend in args.backends:
        for workers in args.workers:
            obs = Obs()
            sess = FlashClusterSession(str(root), cfg, device=dev,
                                       backend=backend, max_workers=workers,
                                       cache_bytes=8 << 30, obs=obs)
            L0 = next(iter(batches))
            torch.cuda.synchronize()
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                sess.search(Query(*batches[L0]))
                torch.cuda.synchronize()
                cold_ms = (time.perf_counter() - t0) * 1e3
            _, cold_busy = device_table(prof, 1)
            print(f"cluster {backend} workers={workers} L={L0}: cold "
                  f"{cold_ms:.1f} ms (device {cold_busy:.3f} ms, idle share "
                  f"{1.0 - cold_busy / cold_ms:.3f}; "
                  f"{sess.last_stats.segments_scored} segments)")
            for L, (qi, qv) in batches.items():
                q = Query(qi, qv)
                sess.search(q)
                wall = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    sess.search(q)
                    wall.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                with profile(activities=activities) as prof:
                    t0 = time.perf_counter()
                    for _ in range(args.reps):
                        sess.search(q)
                    torch.cuda.synchronize()
                    window_ms = (time.perf_counter() - t0) * 1e3
                table, busy = device_table(prof, args.reps)
                idle = 1.0 - busy / (window_ms / args.reps)
                top = "; ".join(f"{k[:60]} {v:.3f}" for k, v in
                                list(table.items())[:6])
                print(f"cluster {backend} workers={workers} L={L}: warm "
                      f"median {statistics.median(wall):.3f} ms, max "
                      f"{max(wall):.3f} (n={args.reps}); device {busy:.3f} "
                      f"ms/query, idle share {idle:.3f} (profiled window); "
                      f"top device: {top}")
                if args.json:
                    print(json.dumps({
                        "cluster": True, "backend": backend, "L": L,
                        "workers": workers, "shards": args.shards,
                        "docs": args.docs, "card": card, "cold_ms": cold_ms,
                        "cold_device_ms": cold_busy,
                        "warm_ms_median": statistics.median(wall),
                        "warm_ms_max": max(wall), "n": args.reps,
                        "warm_device_ms_per_query": busy,
                        "warm_idle_share": idle,
                        "warm_device_ms_by_op": table,
                        "stage_ms": stages_ms(obs)}))
            print(f"cluster {backend} workers={workers} stage_ms (median, "
                  f"mean, n): " + "; ".join(
                      f"{k} {v[0]} {v[1]} {v[2]}"
                      for k, v in stages_ms(obs).items()))
            sess.close()
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
