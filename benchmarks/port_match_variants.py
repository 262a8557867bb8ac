"""How much of each search kernel's time is its lookup: time edited copies
of B1 (``sparse_match.cu``), B2 (``sparse_match_packed.cu``) and B3
(``fused.cu``) beside the kernels as built.

    PYTHONPATH=src python benchmarks/port_match_variants.py [--docs N]
        [--only NAME ...] [--query-nnz N ...] [--rounds R] [--json]

For each variant in ``VARIANTS`` it writes edited copies of the kernel's
source and of ``match.cuh`` to ``build/variants/<n>/`` (the sources stay
as they are), builds them with the port's flags, one nvcc each, in
parallel, and loads each in turn in place of the built library. It times
every variant by CUDA events (one eager call, median of ``--reps``, as
``chip_smoke.py`` phase 7 times the kernels) at the main shapes: the
paper's full-width corpus (SearchConfig defaults, seed 0, 2^20 docs by
default) resident on the card, and the L = 8 request of
``chip_smoke.py`` (Qm = 4096). ``--query-nnz`` adds L = 8 requests of
longer queries, each of N distinct ids (the words of consecutive
documents), and prints what each request gives the tables of B2 and B3.
Each kernel runs as built before and after its variants, ``--rounds``
times over (as built, the variants, as built again, and again), so the
as-built readings show the run's spread. A variant computes another
function than the kernel (a constant miss matches nothing), so only its
time is read. Needs a card and nvcc.

Variants. For each of B1, B2 and B3, "constant miss" replaces the
lookup by one that never finds the id (a comparison the compiler cannot
fold, so every doc word is still read and decoded): the kernel's time
less this one's is what its lookups and hits cost. "hits add nothing"
keeps the probes and drops the hits' sums. The others take back one
design choice each, as the source notes name them: B2 by the binary
search of its first design (B1's loop over packed words, the kernel the
table replaced), the table at load 1/2 instead of 1/4, runs walked
instead of summed ahead, B2's passes as narrow as 1 or 2 columns or no
narrower than 8 (instead of 4) before its hits walk, B2 without its
register cap (three blocks an SM instead of four), B2's query tile at
its least shared memory (instead of what its registers leave), B3
with the tile read from device memory, with each lane's rows rescanned
in shared memory in the epilogue, with 512 threads a block (one block
an SM); and B3 cut down to its copy, its copy and scan, or without its
match or its epilogue, which splits its time by phase.
``--only`` runs the variants whose names hold one of its strings.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its timing and seeded requests)

from repro_torch.configs.paper_search import SearchConfig  # noqa: E402
from repro_torch.core import corpus as corpus_lib  # noqa: E402
from repro_torch.core.engine import PatternSearchEngine  # noqa: E402
from repro_torch.kernels import _build, fused  # noqa: E402
from repro_torch.kernels.sparse_match import (  # noqa: E402
    query_tiles, sparse_match)
from repro_torch.kernels.sparse_match_packed import (  # noqa: E402
    MIN_PASS_COLS, sparse_match_packed, tile_bytes)

# the line of B1's loop, and of B2's and B3's table probe, that looks up,
# and the lines the other variants edit
B1_LOOKUP = "          run_sum<LC>(s_ids, n, sorted, id, qv, L, c0, nc, m);\n"
B1_MISS = ("          if (id == n + (1 << 30))\n"
           "            run_sum<LC>(s_ids, n, sorted, id, qv, L, c0, nc, m);\n"
           "          else\n"
           "            for (int c = 0; c < LC; ++c) m[c] = 0.f;\n")
TABLE_LOOKUP = "      s[j] = ok[j] ? qt.tab[h[j]] : kEmpty;   // the lookup\n"
TABLE_MISS = ("      s[j] = ok[j] && id[j] == qt.n_real + (1 << 21) ? 0 : "
              "kEmpty;\n")
WALK = ("    cols = plan.cols;\n", "    cols = 0;\n")
HIT = "    if (!ok[j] || (qt.sorted && s[j] == kEmpty)) continue;\n"
NO_HIT = ("    if (!ok[j] || (qt.sorted && s[j] != qt.n_real + (1 << 21)))"
          " continue;\n")
LOAD_HALF = (
    "  const int quarter = pow2_slots(4 * n), half = pow2_slots(2 * n);\n",
    "  const int quarter = pow2_slots(2 * n), half = pow2_slots(2 * n);\n")
NO_MATCH = (
    "        for (int r2 = 2 * warp; r2 < n_rows; r2 += 2 * kFusedWarps) {\n",
    "        for (int r2 = 2 * warp; r2 < 0; r2 += 2 * kFusedWarps) {\n")
NO_EPILOGUE = ("      for (int l = warp; l < nc; l += kFusedWarps) {\n",
               "      for (int l = warp; l < 0; l += kFusedWarps) {\n")
# B2's first design: B1's binary-search loop (match_rows) over packed words
FIRST_DESIGN_DOCS = """constexpr uint32_t kPackedMaxKey = (1u << 20) - 1;
struct FirstDesignDocs {
  const uint32_t* words;
  __device__ __forceinline__ bool get(size_t i, int& id, float& v) const {
    const uint32_t w = words[i];
    if (w == kPadWord) return false;
    id = (int)(w >> kValBits);
    v = (float)(w & kValMask);
    return true;
  }
};
"""

# name -> (library, {file: [(line, what it becomes), ...]})
VARIANTS = {
    "B1 constant miss": ("sparse_match",
                         {"match.cuh": [(B1_LOOKUP, B1_MISS)]}),
    "B2 constant miss": ("sparse_match_packed",
                         {"match.cuh": [(TABLE_LOOKUP, TABLE_MISS)]}),
    "B2 runs walked": ("sparse_match_packed", {"match.cuh": [WALK]}),
    **{f"B2 passes of at least {c} columns, else walks": (
        "sparse_match_packed", {"sparse_match_packed.cu": [(
            "constexpr int kMinPassCols = 4;",
            f"constexpr int kMinPassCols = {c};")]})
       for c in (1, 2, 8)},
    "B2 registers not capped for four blocks an SM": (
        "sparse_match_packed", {"sparse_match_packed.cu": [(
            "__launch_bounds__(kThreads, kBlocksPerSm)",
            "__launch_bounds__(kThreads)")]}),
    "B2 query tile at its least": ("sparse_match_packed", {
        "sparse_match_packed.cu": [(
            "  return smem_share(device, packed_kernel<LC>, kThreads, "
            "query_tile_smem(Qm));\n",
            "  return query_tile_smem(Qm);\n")]}),
    "B2 binary search (the first design)": ("sparse_match_packed", {
        "sparse_match_packed.cu": [(
            "constexpr uint32_t kPackedMaxKey = (1u << 20) - 1;  "
            "// w >> 12 of a word\n", FIRST_DESIGN_DOCS), (
            "  return rsm::with_pass_cols(L, [&](auto lc) {\n"
            "    return rsm::launch_packed<decltype(lc)::value>(\n"
            "        device, docs_packed, q_ids, q_vals, out, D, K, Qm, L, "
            "stream);\n  });\n",
            "  return rsm::launch_match(device, rsm::FirstDesignDocs{"
            "docs_packed}, D, K,\n                           q_ids, q_vals, "
            "Qm, L, out, stream);\n")]}),
    "B2 hits add nothing": ("sparse_match_packed",
                            {"match.cuh": [(HIT, NO_HIT)]}),
    "B2 table at load 1/2": ("sparse_match_packed",
                             {"match.cuh": [LOAD_HALF]}),
    "B3 constant miss": ("fused", {"match.cuh": [(TABLE_LOOKUP, TABLE_MISS)]}),
    "B3 hits add nothing": ("fused", {"match.cuh": [(HIT, NO_HIT)]}),
    "B3 table at load 1/2": ("fused", {"match.cuh": [LOAD_HALF]}),
    "B3 runs walked": ("fused", {"match.cuh": [WALK]}),
    "B3 tile read from device memory": ("fused", {"fused.cu": [(
        "  for (int s = 1; s >= 0; --s)\n",
        "  for (int s = 0; s >= 0; --s)\n")]}),
    "B3 512 threads a block": ("fused", {"fused.cu": [
        ("constexpr int kFusedThreads = 256;",
         "constexpr int kFusedThreads = 512;"),
        ("__launch_bounds__(kFusedThreads, 2)",
         "__launch_bounds__(kFusedThreads, 1)")]}),
    "B3 no match (copy, scan, epilogue)": ("fused",
                                           {"fused.cu": [NO_MATCH]}),
    "B3 copy and scan only": ("fused", {"fused.cu": [NO_MATCH, NO_EPILOGUE]}),
    "B3 copy only": ("fused", {"fused.cu": [NO_MATCH, NO_EPILOGUE, (
        "    for (int p0 = a0; p0 < a1; p0 += 128) {\n      uint32_t w[4];\n",
        "    for (int p0 = a0; p0 < 0; p0 += 128) {\n      uint32_t w[4];\n"), (
        "    for (int p0 = a0; p0 < min(a1, end); p0 += 128) {",
        "    for (int p0 = a0; p0 < 0; p0 += 128) {")]}),
    "B3 no epilogue": ("fused", {"fused.cu": [NO_EPILOGUE]}),
    "B3 rows rescanned in shared memory": ("fused", {"fused.cu": [(
        "        if (bd <= 128) {\n", "        if (bd <= 0) {\n")]}),
}


def long_queries(corpus, rng, L: int, nnz: int, max_nnz: int):
    """L queries of ``nnz`` distinct ids each, [L, max_nnz] (pad -1): the
    words of consecutive documents from a random one, with their counts,
    as one long document would carry them."""
    qi = np.full((L, max_nnz), -1, np.int32)
    qv = np.zeros((L, max_nnz), np.float32)
    for l in range(L):
        d = int(rng.integers(0, corpus.n_docs))
        words = {}
        while len(words) < nnz:
            row = corpus.ids[d % corpus.n_docs]
            for i, v in zip(row[row >= 0], corpus.vals[d % corpus.n_docs]):
                if len(words) < nnz:
                    words.setdefault(int(i), float(v))
            d += 1
        ids = np.array(sorted(words), np.int32)
        qi[l, :nnz] = ids
        qv[l, :nnz] = [words[int(i)] for i in ids]
    return qi, qv


def build_variants(out_dir: Path) -> dict:
    """{variant: path of its built library}; raises if an edit misses."""
    procs = {}
    for i, (name, (lib, edits)) in enumerate(VARIANTS.items()):
        d = out_dir / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for src in ("match.cuh", f"{lib}.cu"):
            text = (_build.CSRC / src).read_text()
            for old, new in edits.get(src, []):
                if text.count(old) != 1:
                    raise RuntimeError(f"variant {name!r}: its line is not "
                                       f"in {src} once")
                text = text.replace(old, new)
            (d / src).write_text(text)
        so = d / f"{lib}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
             "-o", str(so), str(d / f"{lib}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
    return {name: so for name, (so, _) in procs.items()}


def load(lib: str, path) -> None:
    """The library at ``path`` in place of ``lib`` (None: the built one)."""
    _build._libs.pop(lib, None)
    if path is None:
        return
    handle = ctypes.CDLL(str(path))
    handle.rsm_error_string.argtypes = [ctypes.c_int]
    handle.rsm_error_string.restype = ctypes.c_char_p
    _build._libs[lib] = handle


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=chip_smoke.N_DOCS)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=1,
                    help="times over: as built, the variants, as built")
    ap.add_argument("--query-nnz", type=int, nargs="+", default=[],
                    help="also time L = 8 requests of queries of this "
                         "many distinct ids")
    ap.add_argument("--only", nargs="+", default=None,
                    help="run only the variants whose names hold one of "
                         "these strings")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.only:
        for name in list(VARIANTS):
            if not any(s in name for s in args.only):
                del VARIANTS[name]
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(f"card: {chip_smoke.nvidia_smi_line()}", flush=True)
    _build.build(["sparse_match", "sparse_match_packed", "fused"])
    libs = build_variants(_build.BUILD_DIR.parent / "variants")

    cfg = SearchConfig(name="paper-full")
    corpus = corpus_lib.synthesize(args.docs, cfg.vocab_size,
                                   cfg.avg_nnz_per_doc, cfg.nnz_pad,
                                   seed=chip_smoke.SEED)
    rng = np.random.default_rng(chip_smoke.SEED)
    for L in range(1, 9):                  # chip_smoke's requests, L = 8 last
        idx = rng.integers(0, args.docs, L)
    qs = [corpus_lib.make_query(corpus, int(i), cfg.max_query_nnz)
          for i in idx]
    requests = [("main", np.stack([q[0] for q in qs]),
                 np.stack([q[1] for q in qs]))]
    for nnz in args.query_nnz:
        requests.append((f"{nnz} nnz", *long_queries(
            corpus, np.random.default_rng(nnz), 8, nnz, cfg.max_query_nnz)))
    g, p, f = (PatternSearchEngine(corpus, cfg, dev, b)
               for b in ("gpu", "gpu_packed", "gpu_fused"))
    bd = f._block_docs
    kp = min(cfg.top_k, bd)
    print(f"shapes: D={args.docs} K={cfg.nnz_pad} "
          f"tiles={tuple(f.f_tiles.shape)} kp={kp}", flush=True)
    rows = []
    for request, qi, qv in requests:
        Lp, mi, mv, qn = g.merged_stream(qi, qv)
        q_ids, q_vals, q_norms = (torch.from_numpy(a).to(dev)
                                  for a in (mi, mv, qn))
        (b3,) = query_tiles(mi, fused.KEY_MASK)[:1]
        (b2,) = query_tiles(mi, (1 << 20) - 1, min_cols=MIN_PASS_COLS,
                            tile_bytes=tile_bytes(dev, mi.size, Lp))[:1]
        print(f"request {request}: L={Lp} Qm={mi.size} real={b3['real']} "
              f"distinct={b3['distinct']} B2 slots={b2['slots']} "
              f"sums={b2['sum_cols']} B3 slots={b3['slots']} "
              f"sums={b3['sum_cols']}", flush=True)
        calls = {
            "sparse_match": lambda: sparse_match(g.d_ids, g.d_vals, q_ids,
                                                 q_vals),
            "sparse_match_packed": lambda: sparse_match_packed(
                p.d_ids, q_ids, q_vals),
            "fused": lambda: fused.fused_match_topk(
                f.f_tiles, q_ids, q_vals, q_norms, block_docs=bd, kp=kp),
        }
        for lib, call in calls.items():
            if not any(l == lib for l, _ in VARIANTS.values()):
                continue
            runs = [(name, libs[name]) for name, (l, _) in VARIANTS.items()
                    if l == lib]
            runs = ([("as built", None)]
                    + (runs + [("as built, again", None)]) * args.rounds)
            for name, path in runs:
                load(lib, path)
                ms = chip_smoke.cuda_ms(torch, call, args.reps)
                rows.append({"request": request, "kernel": lib,
                             "variant": name, "ms": ms})
                print(f"{request}: {lib}: {name}: {ms:.4f} ms", flush=True)
            load(lib, None)
    if args.json:
        print(json.dumps({"card": chip_smoke.nvidia_smi_line(),
                          "rows": rows}))


if __name__ == "__main__":
    main()
