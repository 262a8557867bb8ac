"""The first request of each L bucket against its warm repeats, on the
card, for the port on ``PYTHONPATH``.

    PYTHONPATH=src python benchmarks/port_first_requests.py [--docs N] [--json]

Builds the gpu, gpu_packed, gpu_fused and torch engines over N
synthesized documents at the paper's full width (seed 0; 2^20 by
default), as ``chip_smoke.py`` phase 3 does, then sends the requests
L = 1..8 (self-queries, seed 0) through each kernel backend twice and
prints the host ms of every request: the first pass pays what the first
request of a new L bucket pays, the second is warm. To hold two trees
against each other on one card, run it once for each, in turns, in one
call: e.g. the parent unpacked by ``git archive`` under
``build/parent``, then

    for t in build/parent . . build/parent; do
        PYTHONPATH=$t/src python benchmarks/port_first_requests.py; done

Needs a card; it does not run on the CPU.
"""
import argparse
import json
import subprocess
import time

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=1 << 20)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("port_first_requests: needs a CUDA card")
    import repro_torch
    from repro_torch.configs.paper_search import SearchConfig
    from repro_torch.core import corpus as corpus_lib
    from repro_torch.core.engine import PatternSearchEngine
    from repro_torch.serve import Query

    dev = torch.device("cuda", 0)
    cfg = SearchConfig(name="paper-full")
    corpus = corpus_lib.synthesize(args.docs, cfg.vocab_size,
                                   cfg.avg_nnz_per_doc, cfg.nnz_pad, seed=0)
    engines = {b: PatternSearchEngine(corpus, cfg, dev, b)
               for b in ("gpu", "gpu_packed", "gpu_fused", "torch")}
    rng = np.random.default_rng(0)
    requests = []
    for L in range(1, 9):
        idx = rng.integers(0, args.docs, L)
        qs = [corpus_lib.make_query(corpus, int(i), cfg.max_query_nnz)
              for i in idx]
        requests.append(Query(np.stack([q[0] for q in qs]),
                              np.stack([q[1] for q in qs])))
    torch.cuda.synchronize()
    rows = {}
    for backend in ("gpu", "gpu_packed", "gpu_fused"):
        for p in ("first", "warm"):
            ms = []
            for q in requests:
                t0 = time.perf_counter()
                engines[backend].search(q)
                ms.append((time.perf_counter() - t0) * 1e3)
            rows[f"{backend} {p}"] = ms
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if args.json:
        print(json.dumps({"tree": repro_torch.__file__, "card": card,
                          "docs": args.docs, "host_ms": rows}))
        return
    print(f"tree {repro_torch.__file__}; {args.docs} docs; {card}")
    for name, ms in rows.items():
        print(f"  {name:18s} L=1..8 ms " + ", ".join(f"{t:.2f}" for t in ms))


if __name__ == "__main__":
    main()
