#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, with one card and the CUDA toolkit. Phases,
each of which fails the run (non-zero exit) if it fails:

  1. card      the card's name and power limit (nvidia-smi);
  2. build     the four kernels from ``src/repro_torch/kernels/csrc``,
               one nvcc each, in parallel;
  3. corpus    the paper's full-width configuration (SearchConfig
               defaults: vocab 141 000, ~60 nnz/doc, nnz_pad 128, top_k
               16) at 2^20 synthesized documents, seed 0, resident on the
               card in each backend's layout;
  4. kernels   each kernel against its plain PyTorch version on the
               main path's inputs (the L = 8 request): integral counts
               must agree exactly; one float-valued ELL case within its
               stated tolerance; what the hashed query table of B1, B2
               and B3 holds for that request (real items, distinct ids,
               slots, run-sum columns, B1's and B2's query tile bytes on
               the card) and the share of doc words that hit;
  5. launcher  ``repro_torch.launch.search.main`` on the card;
  6. main path 8 requests (L = 1..8) through ``PatternSearchEngine.
               search`` on gpu, gpu_packed and gpu_fused, then
               ``search_streaming`` over 4 slabs of 2^18 docs, with every
               launch counter set to 0 before and read after: each
               kernel must have launched; every self-query must rank
               itself first; the three backends and the ``torch`` gather
               path must agree bit for bit, streaming with resident;
  7. times     each search kernel, its plain version and the library
               yardstick (torch.sparse.mm, CSR [D, V] x dense [V, L]) by
               CUDA events, median of repeats, beside the bound the card's
               memory rate puts on the same bytes;
  8. attention flash attention (B4) against its plain version at the
               qwen2-0.5b prefill shape (B 4, S 1024, 14 heads over 2 kv
               heads, hd 64) in bf16 (its wgmma instance) and f32 (its
               simt instance), non-causal, and at an S that no tile
               divides; each case must count under the instance that
               ``fa.design`` names; bf16 within ATTN_TOL and, beside it,
               within ATTN_ROW_TOL of each output row's largest entry;
  9. LM path   ``repro_torch.launch.serve.main``: qwen2-0.5b at full width
               (24 layers, d_model 896, vocab 151 936) from seed 0 in bf16,
               4 prompts of 1024 random tokens, 32 greedy tokens, with the
               launch counts set to 0 before and read after: B4 must have
               launched once a layer (24), all 24 on the wgmma instance;
               then the same call again, warm, for the prefill and decode
               times;
 10. LM checks the model with prefill attention by the kernel and then by
               its plain version, same weights and prompts, first in bf16
               (the main path's weights; the wgmma instance) within
               LM_ATOL["bfloat16"], then in f32 (the simt instance) within
               LM_ATOL["float32"]: last-position prefill logits within the
               tolerance, and the greedy tokens equal or, at the first
               difference, the plain path's top-2 margin below it;
 11. B4 times  the kernel, its plain version and the library yardstick
               (scaled_dot_product_attention, causal, GQA) by CUDA events
               at the prefill shape (kernel and library as CUDA-graph
               replays of 10 calls, so no host time between launches;
               eager calls printed beside), beside its bound: causal
               FLOPs 2·B·H·S²·hd over the bf16 tensor-core peak, or the
               bytes of q, k, v and o over the memory rate, the larger.

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
BF16_OPS_PER_S = 989e12              # H100 SXM bf16 tensor cores, dense
FLOAT_RTOL = 1e-5
LM_ARCH = "qwen2-0.5b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 1024, 32
# B4 against its plain version: sums in another order (f32); outputs
# rounded to bf16, 8 bits (tests/test_flash_kernel.py's tolerances)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# bf16 beside it, per output row (one (b, s, h) vector of hd entries):
# max |kernel - plain| over the row's max |plain|. Both round the same
# f32 value, summed in another order, to 8 bits, so an entry may differ
# by one bf16 ulp of itself, at most 2^-7 of the row's largest entry;
# the limit is two such ulps. A query row's output is ~0.05-0.2 where
# 3e-2 would pass a kernel that dropped a 64-key tile of it.
ATTN_ROW_TOL = 2.0 ** -6
# the model with the kernel against the same model with plain attention.
# f32: 24 layers carry each attention's ~1e-6 relative difference.
# bf16: outputs keep 8 bits, so kernel and plain round ~1 in 10^3 entries
# of an attention output the other way (one ulp, 2^-8 relative); random
# weights do not damp that, and 24 layers carry it into every later
# rounding: a few bf16 ulps of the logits (one ulp is 1.6e-2 at |logit|
# 2-4), so 0.1, ~3% of the logits' scale; a wrong tile or mask moves
# them by O(1).
LM_ATOL = {"float32": 1e-3, "bfloat16": 0.1}


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


def row_scaled_err(got, want) -> float:
    """max over output rows (the last dim) of max |got - want| over the
    row's max |want|."""
    err = (got.float() - want.float()).abs().amax(-1)
    return float((err / want.float().abs().amax(-1).clamp_min(1e-30)).max())


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


def graph_ms(torch, fn, reps, per_graph=10):
    """Device time of one ``fn``: ``per_graph`` calls captured in a CUDA
    graph, the median of ``reps`` replays by CUDA events over
    ``per_graph``. No host time between launches: for kernels that are
    shorter than their Python wrapper's launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(per_graph):
            fn()
    return cuda_ms(torch, graph.replay, reps) / per_graph


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over ``ops_per_s``, in ms."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
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
    from repro_torch.kernels import sparse_match_packed as b2
    from repro_torch.kernels.sparse_match import (
        MAX_KEY, MIN_PASS_COLS, query_tiles, sparse_match, sparse_match_plain,
        tile_bytes)
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
        # ptxas -v: each kernel's (mangled) name, then its registers and
        # shared memory
        regs = [ln.split("Used ")[1] if "Used " in ln else ln.split("'")[1]
                for ln in r["log"].splitlines()
                if "Used " in ln or "entry function" in ln]
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
    # what the request gives each kernel's table: B1 holds every id, B2
    # those below 2^20, B3 those up to 2^19 - 1; B1's and B2's query tiles
    # take what their registers leave (tile_bytes, from the card)
    b1_bytes = tile_bytes(dev, mi.size, Lp)
    b2_bytes = b2.tile_bytes(dev, mi.size, Lp)
    tables = {
        "B1": query_tiles(mi, MAX_KEY, min_cols=MIN_PASS_COLS,
                          tile_bytes=b1_bytes),
        "B2": query_tiles(mi, (1 << 20) - 1, min_cols=MIN_PASS_COLS,
                          tile_bytes=b2_bytes),
        "B3": query_tiles(mi, fused.KEY_MASK)}
    words = g.d_ids[g.d_ids >= 0]
    hit = float(torch.isin(words, q_ids[q_ids >= 0]).double().mean())
    table = tables["B3"]
    say(f"query table (L={Lp} request): {table[0]['real']} real items of "
        f"{mi.size} ({len(table)} tile, sorted {table[0]['sorted']}); "
        + "; ".join(f"{k}: {t[0]['distinct']} distinct ids in "
                    f"{t[0]['slots']} slots, run sums of {t[0]['sum_cols']} "
                    f"columns" for k, t in tables.items())
        + f"; query tiles B1 {b1_bytes} B, B2 {b2_bytes} B; {hit:.4f} of the "
        f"{words.numel()} doc words hit")
    del words
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
        say(f"time {name}: {ms:.4f} ms, {ms / b_ms:.2f}x its bound (plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}, "
            f"{work[name][0] / 1e9:.3f} GB; library {library})")
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
    del engines, g, p, f, corpus, slabs, csr, dq
    torch.cuda.empty_cache()

    rows.append(lm_phases(torch, dev))
    say(nvidia_smi_line())
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def attention_inputs(torch, dev, B, S, H, KV, hd, dtype, seed=SEED):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((B, S, h, hd), generator=gen, device=dev).to(dtype)
            for h in (H, KV, KV)]


def greedy_with_margins(torch, step, params, cfg, prompt, max_new):
    """``generate``'s greedy loop, also returning each step's top-2 logit
    margin [B, max_new] and the last-position prefill logits."""
    from repro_torch.models import model as M
    B, S = prompt.shape
    logits, kv = step.make_prefill(cfg)(params, {"tokens": prompt})
    first = logits[:, 0].clone()
    cache = M.init_cache(cfg, B, S + max_new, prompt.device)
    cache["k"][:, :, :S] = kv["k"]
    cache["v"][:, :, :S] = kv["v"]
    decode = step.make_decode_step(cfg)
    toks, margins = [], []
    for i in range(max_new):
        top2 = logits[:, 0].float().topk(2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        toks.append(step.sample(logits))
        if i < max_new - 1:
            logits, cache = decode(params, {"tokens": toks[-1]}, cache, S + i)
    return torch.cat(toks, 1), torch.stack(margins, 1), first


def lm_check(torch, step, layers, fa, params, cfg, prompt, label):
    """Phase 10 in ``cfg.dtype``: the model with kernel B4 against the
    same model with its plain version. Returns the logits' max error."""
    by = fa.flash_attention_gqa.launches_by_design
    before = dict(by)
    tok_k, _, logit_k = greedy_with_margins(torch, step, params, cfg,
                                            prompt, LM_NEW)
    which = fa.design(getattr(torch, cfg.dtype), cfg.head_dim)
    if by[which] - before[which] != cfg.n_layers:
        fail(f"LM check {label}: the prefill did not run B4's {which} "
             "instance once a layer")
    kernel_attn = layers.flash_attention_gqa
    layers.flash_attention_gqa = fa.flash_attention_gqa_plain
    try:
        tok_p, margin_p, logit_p = greedy_with_margins(
            torch, step, params, cfg, prompt, LM_NEW)
    finally:
        layers.flash_attention_gqa = kernel_attn
    torch.cuda.synchronize()
    atol = LM_ATOL[cfg.dtype]
    err = float((logit_k.float() - logit_p.float()).abs().max())
    say(f"LM check {label} ({which}): last-position prefill logits max "
        f"|kernel - plain| {err:.3e} (tolerance {atol}; max |logit| "
        f"{float(logit_p.float().abs().max()):.3f})")
    if not (err <= atol and torch.isfinite(logit_k).all()):
        fail(f"{label} prefill logits differ by {err} > {atol}")
    diff = (tok_k != tok_p).nonzero()
    if len(diff):
        t = int(diff[:, 1].min())
        rows_t = diff[diff[:, 1] == t][:, 0].tolist()
        margins = [float(margin_p[r, t]) for r in rows_t]
        say(f"LM check {label}: greedy tokens first differ at step {t} in "
            f"rows {rows_t}; plain top-2 margins there {margins}")
        if max(margins) >= atol:
            fail("greedy tokens differ where the margin exceeds tolerance")
    else:
        say(f"LM check {label}: the {tok_k.shape[0]} x {LM_NEW} greedy "
            f"tokens agree; smallest plain top-2 margin "
            f"{float(margin_p.min()):.3e}")
    return err


def lm_phases(torch, dev):
    """Phases 8-11: kernel B4 and the LM serving path. Returns B4's row
    of the kernels line."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models import layers, model as M
    from repro_torch.serve import step

    cfg = get_config(LM_ARCH)
    B, S, H, KV, hd = (LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    by = fa.flash_attention_gqa.launches_by_design

    # -- 8. B4 against its plain version -----------------------------------
    cases = [("prefill bf16 causal", B, S, "bfloat16", True),
             ("prefill f32 causal", B, S, "float32", True),
             ("prefill bf16 non-causal", B, S, "bfloat16", False),
             ("bf16 causal S=1000 (no 64-tile divides)", 2, 1000,
              "bfloat16", True)]
    attn_err = {}
    for name, b, s_len, dtype, causal in cases:
        q, k, v = attention_inputs(torch, dev, b, s_len, H, KV, hd,
                                   getattr(torch, dtype))
        which = fa.design(q.dtype, hd)
        before = by[which]
        got = fa.flash_attention_gqa(q, k, v, causal=causal)
        want = fa.flash_attention_gqa_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if by[which] != before + 1:
            fail(f"B4 {name}: not counted under its {which} instance")
        err = float((got.float() - want.float()).abs().max())
        row_err = row_scaled_err(got, want)
        tol = ATTN_TOL[dtype]
        say(f"B4 ({which}) vs plain, {name} [{b}, {s_len}, {H}/{KV}, {hd}]: "
            f"max_abs_err {err:.3e} (tolerance {tol}, rtol {tol}); "
            f"row-scaled {row_err:.3e}"
            + (f" (tolerance {ATTN_ROW_TOL})" if dtype == "bfloat16" else ""))
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        if dtype == "bfloat16" and row_err > ATTN_ROW_TOL:
            fail(f"B4 {name}: row-scaled error {row_err} > {ATTN_ROW_TOL}")
        attn_err[name] = err
    bh = attention_inputs(torch, dev, B * H, S, 1, 1, hd, torch.bfloat16)
    got = fa.flash_attention(*(t[:, :, 0] for t in bh))
    want = fa.flash_attention_plain(*(t[:, :, 0] for t in bh))
    torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)
    row_err = row_scaled_err(got, want)
    say(f"B4 vs plain, [BH, S, hd] entry [{B * H}, {S}, {hd}] bf16: "
        f"max_abs_err {float((got.float() - want.float()).abs().max()):.3e}"
        f", row-scaled {row_err:.3e}")
    if row_err > ATTN_ROW_TOL:
        fail(f"B4 [BH, S, hd] entry: row-scaled error {row_err} > "
             f"{ATTN_ROW_TOL}")
    del q, k, v, got, want, bh

    # -- 9. LM main path ---------------------------------------------------
    argv = ["--arch", LM_ARCH, "--batch", str(B), "--prompt-len", str(S),
            "--max-new", str(LM_NEW), "--seed", str(SEED)]
    counted = _launch_counters()
    for fn in counted.values():
        fn.launches = 0
    for name in by:
        by[name] = 0
    run = serve_launcher.main(argv)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    by_design = dict(by)
    say(f"LM main path launches: {launches}; B4 by instance {by_design}")
    if launches["flash_attention"] != cfg.n_layers:
        fail(f"B4 launched {launches['flash_attention']} times in one "
             f"prefill, want {cfg.n_layers} (one a layer)")
    if by_design["wgmma"] != cfg.n_layers:
        fail(f"{by_design['wgmma']} of B4's {cfg.n_layers} prefill launches "
             "ran the wgmma instance, want all")
    tokens = run.tokens
    if tuple(tokens.shape) != (B, LM_NEW) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        fail(f"LM tokens: shape {tuple(tokens.shape)}, range "
             f"[{int(tokens.min())}, {int(tokens.max())}]")
    n_params = sum(t.numel() for t in _leaves(run.params))
    say(f"LM model: {cfg.name}, {cfg.n_layers} layers x d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params} params "
        f"({n_params * 2 / 1e9:.2f} GB bf16) initialised in "
        f"{run.stats['init_s']:.1f} s; first call: prefill "
        f"{run.stats['prefill_s'] * 1e3:.1f} ms, decode "
        f"{run.stats['decode_s'] * 1e3:.1f} ms")
    warm = []
    for _ in range(3):
        stats = {}
        fa.flash_attention_gqa.launches = 0
        again = step.generate(run.params, cfg, run.prompt, max_new=LM_NEW,
                              max_len=S + LM_NEW, device=dev, stats=stats)
        if fa.flash_attention_gqa.launches != cfg.n_layers:
            fail("B4 launch count differs on the warm call")
        if not torch.equal(again, tokens):
            fail("the warm call's greedy tokens differ from the first's")
        warm.append(stats)
    pre = statistics.median(w["prefill_s"] for w in warm) * 1e3
    dec = statistics.median(w["decode_s"] for w in warm) * 1e3
    total_s = (pre + dec) / 1e3
    say(f"LM warm (median of 3): prefill + first token {pre:.2f} ms "
        f"({B * S / (pre / 1e3):.0f} prompt tok/s), decode "
        f"{dec / (LM_NEW - 1):.3f} ms/step of {B} tokens "
        f"({B * (LM_NEW - 1) / (dec / 1e3):.1f} tok/s); "
        f"{B * LM_NEW / total_s:.1f} generated tok/s end to end")

    # -- 10. whole model: kernel against plain attention, bf16 then f32 ------
    lm_check(torch, step, layers, fa, run.params, cfg,
             torch.as_tensor(run.prompt, device=dev), "bf16")
    del run, again
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = M.init(cfg32, seed=SEED, device=dev)
    prompt = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32), device=dev)
    lm_check(torch, step, layers, fa, params32, cfg32, prompt, "f32")
    del params32
    torch.cuda.empty_cache()

    # -- 11. B4 times --------------------------------------------------------
    q, k, v = attention_inputs(torch, dev, B, S, H, KV, hd, torch.bfloat16)
    which = fa.design(q.dtype, hd)
    # device times from CUDA-graph replays: the wrapper's host work is
    # longer than the kernel, so one eager call would time the host
    eager_ms = cuda_ms(torch, lambda: fa.flash_attention_gqa(q, k, v), 20)
    ms = graph_ms(torch, lambda: fa.flash_attention_gqa(q, k, v), 20)
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_gqa_plain(q, k, v),
                       3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_eager_ms = cuda_ms(torch, lib, 20)
    lib_ms = graph_ms(torch, lib, 20)
    lib_err = float((lib().transpose(1, 2).float()
                     - fa.flash_attention_gqa(q, k, v).float()).abs().max())
    flops = 2 * B * H * S * S * hd
    b_ms, b_by = bound(nbytes(q, k, v) + nbytes(q), flops, BF16_OPS_PER_S)
    say(f"time flash_attention ({which}) [{B}, {S}, {H}/{KV}, {hd}] bf16 "
        f"causal: {ms:.4f} ms a launch in a CUDA graph, {eager_ms:.4f} ms "
        f"an eager call (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by "
        f"{b_by}: {flops / 1e9:.2f} GFLOP, "
        f"{(nbytes(q, k, v) + nbytes(q)) / 1e6:.1f} MB; library "
        f"scaled_dot_product_attention {lib_ms:.4f} ms in a graph, "
        f"{lib_eager_ms:.4f} ms eager, max |diff| "
        f"{lib_err:.3e}); kernel / library {ms / lib_ms:.2f}x, kernel / "
        f"bound {ms / b_ms:.1f}x")
    return {"name": "flash_attention", "route": "cuda", "design": which,
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:29",
            "launches": launches["flash_attention"],
            "max_abs_err": attn_err["prefill bf16 causal"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def _launch_counters():
    from repro_torch.kernels import flash_attention as fa, fused
    from repro_torch.kernels.sparse_match import sparse_match
    from repro_torch.kernels.sparse_match_packed import sparse_match_packed
    return {"sparse_match": sparse_match,
            "sparse_match_packed": sparse_match_packed,
            "fused_match_topk": fused.fused_match_topk,
            "flash_attention": fa.flash_attention_gqa}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
