"""Where a request's time goes in the PyTorch/CUDA port, on one CUDA card.

    PYTHONPATH=src python benchmarks/port_request_profile.py [--docs N]

Synthesizes the paper's full-width corpus (SearchConfig defaults, seed
0; 2^20 docs by default), builds a resident engine per backend and, for
each batch size L, times ``PatternSearchEngine.search`` on the host
clock (median and max of ``--reps`` runs; the call ends in host arrays,
so the card is done) and the host-side query preparation alone
(``merged_stream``). One more window of ``--reps`` requests runs under
``torch.profiler``: device time per kernel (and copy), per request, and
the device's idle share of that window's wall time. Prints one line per
(backend, L) and one JSON object per (backend, L) with ``--json``.
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


if __name__ == "__main__":
    main()
