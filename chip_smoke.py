#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, with one card and the CUDA toolkit. Phases,
each of which fails the run (non-zero exit) if it fails:

  1. card      the card's name and power limit (nvidia-smi);
  2. build     the three kernels from ``src/repro_torch/kernels/csrc``,
               one nvcc each, in parallel;
  3. corpus    the paper's full-width configuration (SearchConfig
               defaults: vocab 141 000, ~60 nnz/doc, nnz_pad 128, top_k
               16) at 2^20 synthesized documents, seed 0, resident on the
               card in each backend's layout;
  4. kernels   each kernel against its plain PyTorch version on the
               main path's inputs (the L = 8 request): integral counts
               must agree exactly; one float-valued ELL case within its
               stated tolerance;
  5. launcher  ``repro_torch.launch.search.main`` on the card;
  6. main path 8 requests (L = 1..8) through ``PatternSearchEngine.
               search`` on gpu, gpu_packed and gpu_fused, then
               ``search_streaming`` over 4 slabs of 2^18 docs, with every
               launch counter set to 0 before and read after: each
               kernel must have launched; every self-query must rank
               itself first; the three backends and the ``torch`` gather
               path must agree bit for bit, streaming with resident;
  7. times     each kernel, its plain version and the library yardstick
               (torch.sparse.mm, CSR [D, V] x dense [V, L]) by CUDA
               events, median of repeats, beside the bound the card's
               memory rate puts on the same bytes.

It prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true,
"device": {...}}``. Without a card, or without the repo beside it, it
exits non-zero and prints no result.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_DOCS = 1 << 20
N_SLABS = 4
SEED = 0
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
F32_OPS_PER_S = 67e12                # H100 SXM float32, outside tensor cores
FLOAT_RTOL = 1e-5


def say(*args):
    print(*args, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Median time of ``fn`` on the card by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 rate, in ms."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same(a, b) -> bool:
    return (np.array_equal(a.doc_ids, b.doc_ids)
            and np.array_equal(a.scores.view(np.uint32),
                               b.scores.view(np.uint32)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.configs.paper_search import SearchConfig
    from repro_torch.core import corpus as corpus_lib
    from repro_torch.core.engine import PatternSearchEngine
    from repro_torch.kernels import _build, fused, ops, ref
    from repro_torch.kernels.sparse_match import (sparse_match,
                                                  sparse_match_plain)
    from repro_torch.kernels.sparse_match_packed import (
        sparse_match_packed, sparse_match_packed_plain)
    from repro_torch.launch import search as launcher
    from repro_torch.serve import Query

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 1. card ---------------------------------------------------------
    card = nvidia_smi_line()
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build()
    say(f"build: {time.perf_counter() - t0:.1f} s wall for "
        f"{len(report)} libraries (one nvcc each, in parallel)")
    for name, r in report.items():
        regs = [ln.split("Used ")[1] for ln in r["log"].splitlines()
                if "Used " in ln]
        say(f"  {name}: {r['seconds']:.1f} s; ptxas: {' | '.join(regs)}")
    for name in _build.SOURCES:
        if not _build.library_path(name).exists():
            fail(f"{name} did not build")

    # -- 3. corpus -------------------------------------------------------
    cfg = SearchConfig(name="paper-full")
    t0 = time.perf_counter()
    corpus = corpus_lib.synthesize(N_DOCS, cfg.vocab_size,
                                   cfg.avg_nnz_per_doc, cfg.nnz_pad,
                                   seed=SEED)
    n_pairs = int((corpus.ids >= 0).sum())
    say(f"corpus: {N_DOCS} docs x nnz_pad {cfg.nnz_pad}, vocab "
        f"{cfg.vocab_size}, {n_pairs} pairs, synthesized in "
        f"{time.perf_counter() - t0:.1f} s")
    engines = {}
    for backend in ("gpu", "gpu_packed", "gpu_fused", "torch"):
        t0 = time.perf_counter()
        engines[backend] = PatternSearchEngine(corpus, cfg, dev, backend)
        torch.cuda.synchronize()
        say(f"  engine {backend}: resident in "
            f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    requests = []
    for L in range(1, 9):
        idx = rng.integers(0, N_DOCS, L)
        qs = [corpus_lib.make_query(corpus, int(i), cfg.max_query_nnz)
              for i in idx]
        requests.append((idx, np.stack([q[0] for q in qs]),
                         np.stack([q[1] for q in qs])))

    # -- 4. kernels against their plain versions -------------------------
    g, p, f = engines["gpu"], engines["gpu_packed"], engines["gpu_fused"]
    Lp, mi, mv, qn = g.merged_stream(*requests[-1][1:])
    q_ids = torch.from_numpy(mi).to(dev)        # -2 pads already
    q_vals = torch.from_numpy(mv).to(dev)
    q_norms = torch.from_numpy(qn).to(dev)
    bd, kp = f._block_docs, min(cfg.top_k, f._block_docs)
    say(f"shapes: D={N_DOCS} K={cfg.nnz_pad} L={Lp} Qm={mi.size} "
        f"tiles={tuple(f.f_tiles.shape)} block_docs={bd} kp={kp}")
    calls = {
        "sparse_match": (
            lambda: sparse_match(g.d_ids, g.d_vals, q_ids, q_vals),
            lambda: sparse_match_plain(g.d_ids, g.d_vals, q_ids, q_vals)),
        "sparse_match_packed": (
            lambda: sparse_match_packed(p.d_ids, q_ids, q_vals),
            lambda: sparse_match_packed_plain(p.d_ids, q_ids, q_vals)),
        "fused_match_topk": (
            lambda: fused.fused_match_topk(f.f_tiles, q_ids, q_vals, q_norms,
                                           block_docs=bd, kp=kp),
            lambda: fused.fused_match_topk_plain(
                f.f_tiles, q_ids, q_vals, q_norms, block_docs=bd, kp=kp)),
    }
    max_err = {}
    for name, (kernel, plain) in calls.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if name == "fused_match_topk":
            if not torch.equal(got[1], want[1]):
                fail(f"{name}: candidate ids differ from the plain version")
            got, want = got[0], want[0]
        if not torch.equal(got.isfinite(), want.isfinite()) or not torch.equal(
                got[~got.isfinite()], want[~want.isfinite()]):
            fail(f"{name}: non-finite entries differ from the plain version")
        fin = got.isfinite()
        max_err[name] = float((got[fin] - want[fin]).abs().max())
        if max_err[name] != 0.0:
            fail(f"{name}: max |kernel - plain| = {max_err[name]} on "
                 "integral counts (must be 0)")
        del got, want
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f_vals = g.d_vals * torch.rand(g.d_vals.shape, generator=gen, device=dev)
    f_qv = q_vals * torch.randn(q_vals.shape, generator=gen, device=dev)
    got = sparse_match(g.d_ids, f_vals, q_ids, f_qv)
    want = sparse_match_plain(g.d_ids, f_vals, q_ids, f_qv)
    atol = 1e-5 * float(want.abs().max())
    f_err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=FLOAT_RTOL, atol=atol)
    say(f"kernels vs plain: {', '.join(calls)} agree exactly on integral "
        f"counts (max_abs_err {max_err}); float-valued sparse_match "
        f"max_abs_err {f_err:.3e} within rtol {FLOAT_RTOL} + atol {atol:.3e}"
        " (1e-5 x max |score|: sums of <= K*L products in another order)")
    del got, want, f_vals, f_qv
    torch.cuda.empty_cache()

    # -- 5. launcher -----------------------------------------------------
    res = launcher.main(["--n-docs", "65536", "--queries", "4",
                         "--backend", "gpu", "--seed", "1"])
    idx = np.random.default_rng(1).integers(0, 65536, 4)
    if not np.array_equal(res.doc_ids[:, 0], idx):
        fail("launcher: a self-query did not rank itself first")

    # -- 6. main path ----------------------------------------------------
    kernels = {"sparse_match": sparse_match,
               "sparse_match_packed": sparse_match_packed,
               "fused_match_topk": fused.fused_match_topk}
    for fn in kernels.values():
        fn.launches = 0
    slabs = [corpus.slice_rows(i * N_DOCS // N_SLABS,
                               (i + 1) * N_DOCS // N_SLABS)
             for i in range(N_SLABS)]
    results, host_ms = {}, {}
    for backend in ("gpu", "gpu_packed", "gpu_fused"):
        eng = engines[backend]
        results[backend], host_ms[backend] = [], []
        for idx, qi, qv in requests:
            t0 = time.perf_counter()
            r = eng.search(Query(qi, qv))
            host_ms[backend].append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(r.doc_ids[:, 0], idx):
                fail(f"{backend}: a self-query did not rank itself first")
            results[backend].append(r)
        t0 = time.perf_counter()
        streamed = eng.search_streaming(requests[2][1], requests[2][2],
                                        iter(slabs))
        s_ms = (time.perf_counter() - t0) * 1e3
        if not same(streamed, results[backend][2]):
            fail(f"{backend}: streaming over {N_SLABS} slabs differs from "
                 "the resident search")
        say(f"main path {backend}: request host ms "
            f"{', '.join(f'{t:.2f}' for t in host_ms[backend])}; streaming "
            f"{N_SLABS} x {N_DOCS // N_SLABS} docs (L=3) {s_ms:.0f} ms "
            f"(uploads included); launch keys "
            f"{eng.compile_stats['buckets']}")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    say(f"main path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the main path")
    ref_results = [engines["torch"].search(Query(qi, qv))
                   for _, qi, qv in requests]
    for backend in ("gpu_packed", "gpu_fused"):
        for l, (a, b) in enumerate(zip(results["gpu"], results[backend])):
            if not same(a, b):
                fail(f"{backend} differs from gpu on request L={l + 1}")
    for l, (a, b) in enumerate(zip(results["gpu"], ref_results)):
        if not same(a, b):
            fail(f"gpu differs from the torch gather path on L={l + 1}")
    say("main path: gpu, gpu_packed, gpu_fused and torch agree bit for bit "
        "on 8 requests; every self-query ranks itself first")

    # -- 7. times ----------------------------------------------------------
    D, K = g.d_ids.shape
    n_valid = int((g.d_ids >= 0).sum())
    q_bytes = nbytes(q_ids, q_vals)
    out_bytes = D * Lp * 4
    csr = torch.sparse_csr_tensor(
        torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                   (g.d_ids >= 0).sum(1).cumsum(0)]),
        g.d_ids[g.d_ids >= 0].long(), g.d_vals[g.d_ids >= 0],
        size=(D, cfg.vocab_size), check_invariants=False)
    dq = ref.dense_query(q_ids, q_vals, cfg.vocab_size)
    lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(csr, dq), 10)
    lib_err = float((torch.sparse.mm(csr, dq) - calls["sparse_match"][0]())
                    .abs().max())
    say(f"library torch.sparse.mm (CSR [D,V] x dense [V,L]): {lib_ms:.4f} ms"
        f" (max |diff| to sparse_match {lib_err})")
    # bytes each input is read once and each output written once (ELL
    # values only where the slot holds a word: a pad slot's value is
    # never needed); operations: a multiply-add per valid slot and column
    work = {
        "sparse_match": (nbytes(g.d_ids) + 4 * n_valid + q_bytes + out_bytes,
                         2 * n_valid * Lp),
        "sparse_match_packed": (nbytes(p.d_ids) + q_bytes + out_bytes,
                                2 * n_valid * Lp),
        "fused_match_topk": (nbytes(f.f_tiles, q_norms) + q_bytes
                             + f.f_tiles.shape[0] * Lp * kp * 8,
                             2 * n_valid * Lp + 2 * n_valid),
    }
    sources = {"sparse_match": ("src/repro_torch/kernels/csrc/sparse_match.cu",
                                "src/repro/kernels/sparse_match.py:39"),
               "sparse_match_packed": (
                   "src/repro_torch/kernels/csrc/sparse_match_packed.cu",
                   "src/repro/kernels/sparse_match_packed.py:40"),
               "fused_match_topk": ("src/repro_torch/kernels/csrc/fused.cu",
                                    "src/repro/kernels/fused.py:170")}
    rows = []
    for name, (kernel, plain) in calls.items():
        ms = cuda_ms(torch, kernel, 20)
        plain_ms = cuda_ms(torch, plain, 3)
        b_ms, b_by = bound(*work[name])
        library = None if name == "fused_match_topk" else lib_ms
        say(f"time {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms by {b_by}, {work[name][0] / 1e9:.3f} GB; "
            f"library {library})")
        rows.append({"name": name, "route": "cuda",
                     "source": sources[name][0],
                     "replaces": sources[name][1],
                     "launches": launches[name],
                     "max_abs_err": max_err[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library})

    # check the script's inputs, outputs and end state once more
    if not all(np.isfinite(r.scores[:, 0]).all() for r in results["gpu"]):
        fail("non-finite top-1 scores")
    say(nvidia_smi_line())
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
