"""Search-service launcher: synthesize a corpus, serve self-queries.

    PYTHONPATH=src python -m repro_torch.launch.search --n-docs 100000 \
        --queries 8 --top-k 10 [--backend gpu] [--device cuda]

``--backend`` picks the scoring kernel (``gpu`` ELL, ``gpu_packed``
Fig. 8 words, ``gpu_fused`` decode+match+top-k; ``torch`` the gather
path). ``--device`` defaults to the CUDA card; ``--device cpu`` runs the
kernels' plain PyTorch versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.paper_search import SearchConfig
from repro_torch.core import corpus as corpus_lib
from repro_torch.core.engine import PatternSearchEngine, SearchResult
from repro_torch.device import resolve
from repro_torch.kernels.ops import BACKENDS
from repro_torch.serve import Query


def main(argv=None) -> SearchResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=100_000)
    ap.add_argument("--vocab", type=int, default=141_000)
    ap.add_argument("--avg-nnz", type=int, default=60)
    ap.add_argument("--nnz-pad", type=int, default=64)
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--backend", choices=BACKENDS, default="gpu")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cfg = SearchConfig(name="service", vocab_size=args.vocab,
                       avg_nnz_per_doc=args.avg_nnz, nnz_pad=args.nnz_pad,
                       top_k=args.top_k)
    print(f"[search] synthesizing {args.n_docs} docs "
          f"(vocab {args.vocab}, ~{args.avg_nnz} nnz/doc)...")
    corpus = corpus_lib.synthesize(args.n_docs, args.vocab, args.avg_nnz,
                                   args.nnz_pad, seed=args.seed)
    eng = PatternSearchEngine(corpus, cfg, device, backend=args.backend)
    rng = np.random.default_rng(args.seed)
    idxs = rng.integers(0, args.n_docs, args.queries)
    qs = [corpus_lib.make_query(corpus, int(i), cfg.max_query_nnz)
          for i in idxs]
    qi = np.stack([q[0] for q in qs])
    qv = np.stack([q[1] for q in qs])

    batch = Query(qi, qv)
    eng.search(batch)             # warm up (first launch builds kernels)
    t0 = time.perf_counter()
    res = eng.search(batch)       # returns host arrays: the card is done
    dt = time.perf_counter() - t0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[search] {args.queries} queries x {args.n_docs} docs in "
          f"{dt*1e3:.1f} ms ({args.n_docs*args.queries/dt:.3e} "
          f"doc-query pairs/s; backend {args.backend} on {name})")
    for l, i in enumerate(idxs):
        hit = "OK" if res.doc_ids[l, 0] == i else "MISS"
        print(f"  q{l} (doc {i}): top1 = doc {res.doc_ids[l, 0]} "
              f"cos {res.scores[l, 0]:.4f} [{hit}]")
    return res


if __name__ == "__main__":
    main()
