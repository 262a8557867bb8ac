"""How much of each search kernel's time is its lookup: time edited copies
of B1 (``sparse_match.cu``), B2 (``sparse_match_packed.cu``) and B3
(``fused.cu``) beside the kernels as built.

    PYTHONPATH=src python benchmarks/port_match_variants.py [--docs N]
        [--only NAME ...] [--L L ...] [--query-nnz N ...] [--rounds R]
        [--baseline DIR] [--json]

For each variant in ``VARIANTS`` it writes edited copies of the kernel's
source and of ``match.cuh`` to ``build/variants/<n>/`` (the sources stay
as they are), builds them with the port's flags, one nvcc each, in
parallel, and loads each in turn in place of the built library. It times
every variant by CUDA events (one eager call, median of ``--reps``, as
``chip_smoke.py`` phase 7 times the kernels) at the main shapes: the
paper's full-width corpus (SearchConfig defaults, seed 0, 2^20 docs by
default) resident on the card, and the L = 8 request of
``chip_smoke.py`` (Qm = 4096; ``--L`` picks others of its requests).
``--query-nnz`` adds L = 8 requests of longer queries, each of N
distinct ids (the words of consecutive documents), and prints what each
request gives the tables of B1-B3.
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
design choice each, as the source notes name them: B1 and B2 by the
binary search of their first design (one warp a row, 256 rows a block;
the script carries that loop as text, ``FIRST_DESIGN``, and launches it
in place of the table's), by their registers not capped for four blocks
an SM, by their query tile at its least shared memory (instead of what
their registers leave), and by runs walked instead of summed ahead; B1
by its value read only where a hit uses it (instead of loaded before
every lookup of a slot that holds a word); B2 by the table at load 1/2
instead of 1/4 and by its passes as narrow as 1 or 2 columns or no
narrower than 8 (instead of 4) before its hits walk; B3 with the table
at load 1/2, runs walked, the tile read from device memory, each lane's
rows rescanned in shared memory in the epilogue, 512 threads a block
(one block an SM); and B3 cut down to its copy, its copy and scan, or
without its match or its epilogue, which splits its time by phase.
``--only`` runs the variants whose names hold one of its strings.
``--baseline DIR`` also builds the kernels of the checkout at DIR (the
parent commit, unpacked by ``git archive`` into a directory that
``.gitignore`` lists) and times them first and last: baseline, as built,
the variants, as built again, baseline again.
"""
import argparse
import ctypes
import json
import re
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
from repro_torch.kernels import sparse_match_packed as b2  # noqa: E402
from repro_torch.kernels.sparse_match import (  # noqa: E402
    MAX_KEY, MIN_PASS_COLS, query_tiles, sparse_match, tile_bytes)

# the line of the table probe (B1-B3) that looks up, and the lines the
# other variants edit
TABLE_LOOKUP = "      s[j] = ok[j] ? qt.tab[h[j]] : kEmpty;   // the lookup\n"
TABLE_MISS = ("      s[j] = ok[j] && id[j] == qt.n_real + (1 << 21) ? 0 : "
              "kEmpty;\n")
WALK = ("    cols = plan.cols;\n", "    cols = 0;\n")
HIT = ("    if (!ok[j] || (qt.sorted && s[j] == kEmpty)) {   "
       "// a pad or a miss\n")
NO_HIT = ("    if (!ok[j] || (qt.sorted && s[j] != qt.n_real + (1 << 21))) "
          "{\n")
LOAD_HALF = (
    "  const int quarter = pow2_slots(4 * n), half = pow2_slots(2 * n);\n",
    "  const int quarter = pow2_slots(2 * n), half = pow2_slots(2 * n);\n")
UNCAPPED = ("__launch_bounds__(kThreads, Docs::kBlocksPerSm)",
            "__launch_bounds__(kThreads)")
LEAST_TILE = ("  return smem_share(device, table_kernel<Docs, LC>, kThreads,\n"
              "                    query_tile_smem(Qm));\n",
              "  return query_tile_smem(Qm);\n")
NO_MATCH = (
    "        for (int r2 = 2 * warp; r2 < n_rows; r2 += 2 * kFusedWarps) {\n",
    "        for (int r2 = 2 * warp; r2 < 0; r2 += 2 * kFusedWarps) {\n")
NO_EPILOGUE = ("      for (int l = warp; l < nc; l += kFusedWarps) {\n",
               "      for (int l = warp; l < 0; l += kFusedWarps) {\n")
# B1's value load where a hit uses it, not before every lookup
ON_HIT = {
    "sparse_match.cu": [(
        "    v = ok ? __ldcs(vals + (size_t)r * K + k) : 0.f;   "
        "// before the lookup\n", "    v = 0.f;\n")],
    "match.cuh": [(
        "template <int LC, int NW, bool FloatVals = false>\n",
        "template <int LC, int NW, bool FloatVals = false, class V>\n"), (
        "                                            const float (&v)[NW],\n",
        "                                            const V& v,\n"), (
        "constexpr int kMinPassCols = 4;",
        "constexpr int kMinPassCols = 4;\n"
        "struct OnHit {\n  const float* p;\n"
        "  __device__ __forceinline__ float operator[](int) const {\n"
        "    return __ldcs(p);\n  }\n};"), (
        "        match_words<LC, 1, Docs::kFloatVals>(qt, q, id, v, ok, "
        "acc);\n",
        "        match_words<LC, 1>(qt, q, id, OnHit{docs.vals + (size_t)r * K"
        " + c * 32 + lane}, ok, acc);\n")]}
# B1's and B2's loop with two slots in flight a lane, not one: the slot
# after next is loaded while this one is looked up, and the next slot's
# word (B1: its value load) is read an iteration ahead of its lookup
LOOP_ONE_AHEAD = """      int r = first, c = 0;
      typename Docs::Slot slot = docs.load(r, lane, D, K);
      while (r < D) {
        int nr = r, nc = c + 1;            // the warp's next load
        if (nc == chunks) {
          nr = r + stride;
          nc = 0;
        }
        const typename Docs::Slot next = docs.load(nr, nc * 32 + lane, D, K);
        int id[1];
        float v[1];
        bool ok[1];
        docs.word(slot, r, c * 32 + lane, K, id[0], v[0], ok[0]);
        match_words<LC, 1, Docs::kFloatVals>(qt, q, id, v, ok, acc);
        if (nc == 0) {                     // row r is done
"""
LOOP_TWO_AHEAD = """      int r = first, nr = r, nc = 1;
      if (nc == chunks) {
        nr = r + stride;
        nc = 0;
      }
      int id[1];
      float v[1];
      bool ok[1];
      docs.word(docs.load(r, lane, D, K), r, lane, K, id[0], v[0], ok[0]);
      typename Docs::Slot next = docs.load(nr, nc * 32 + lane, D, K);
      while (r < D) {
        int ar = nr, ac = nc + 1;
        if (ac == chunks) {
          ar = nr + stride;
          ac = 0;
        }
        const typename Docs::Slot after = docs.load(ar, ac * 32 + lane, D, K);
        int nid[1];
        float nv[1];
        bool nok[1];
        docs.word(next, nr, nc * 32 + lane, K, nid[0], nv[0], nok[0]);
        match_words<LC, 1, Docs::kFloatVals>(qt, q, id, v, ok, acc);
        id[0] = nid[0];
        v[0] = nv[0];
        ok[0] = nok[0];
        next = after;
        const int c = nc;
        nc = ac;
        if (c == 0) {                      // row r is done
"""
TWO_AHEAD = (LOOP_ONE_AHEAD, LOOP_TWO_AHEAD)
TWO_AHEAD_TAIL = ("        r = nr;\n        c = nc;\n        slot = next;\n",
                  "        r = nr;\n        nr = ar;\n")
# The first design of B1 and B2, which the table replaced: one warp a row,
# 256 rows a block, and each slot's run found by binary search of the
# query tile's ids in shared memory, then walked in device memory. It is
# added to match.cuh and launched in place of table_kernel.
FIRST_DESIGN = r"""
__device__ __forceinline__ int load_query_tile(const int* __restrict__ q_ids,
                                               int Qm, int t, int* s_ids,
                                               bool* sorted) {
  const int t0 = t * kMaxTileItems;
  const int n = max(0, min(kMaxTileItems, Qm - t0));
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_ids[i] = q_ids[t0 + i];
  __syncthreads();
  int ok = 1;
  for (int i = threadIdx.x; i + 1 < n; i += blockDim.x)
    ok &= qkey(s_ids[i]) <= qkey(s_ids[i + 1]);
  *sorted = __syncthreads_and(ok) != 0;
  return n;
}

template <int LC>
__device__ __forceinline__ void run_sum(const int* s_ids, int n, bool sorted,
                                        int id, const float* __restrict__ qv,
                                        int L, int c0, int nc,
                                        float (&m)[LC]) {
#pragma unroll
  for (int c = 0; c < LC; ++c) m[c] = 0.f;
  int p = 0;
  if (sorted) {
    int hi = n;
    while (p < hi) {
      const int mid = (p + hi) >> 1;
      if (qkey(s_ids[mid]) < id) p = mid + 1; else hi = mid;
    }
  }
  for (; p < n; ++p) {
    const int q = s_ids[p];
    if (q != id) {
      if (sorted && qkey(q) != id) break;
      continue;
    }
    const float* row = qv + (size_t)p * L + c0;
#pragma unroll
    for (int c = 0; c < LC; ++c)
      if (c < nc) m[c] += __ldg(row + c);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

struct FirstDesignEll {
  const int* ids;
  const float* vals;
  __device__ __forceinline__ bool get(size_t i, int& id, float& v) const {
    id = ids[i];
    if (id < 0) return false;
    v = vals[i];
    return true;
  }
};

struct FirstDesignPacked {
  const uint32_t* words;
  __device__ __forceinline__ bool get(size_t i, int& id, float& v) const {
    const uint32_t w = words[i];
    if (w == kPadWord) return false;
    id = (int)(w >> kValBits);
    v = (float)(w & kValMask);
    return true;
  }
};

template <class Docs, int LC>
__device__ void match_rows(const Docs& docs, int K,
                           const int* __restrict__ q_ids,
                           const float* __restrict__ q_vals, int Qm, int L,
                           float* __restrict__ out, int r0, int r1,
                           int* s_ids) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = n_query_tiles(Qm);
  for (int t = 0; t < nt; ++t) {
    bool sorted;
    const int n = load_query_tile(q_ids, Qm, t, s_ids, &sorted);
    const float* qv = q_vals + (size_t)t * kMaxTileItems * L;
    for (int c0 = 0; c0 < L; c0 += LC) {
      const int nc = min(LC, L - c0);
      for (int r = r0 + warp; r < r1; r += kWarps) {
        float acc[LC];
#pragma unroll
        for (int c = 0; c < LC; ++c) acc[c] = 0.f;
        for (int k = lane; k < K; k += 32) {
          int id;
          float v;
          if (!docs.get((size_t)r * K + k, id, v)) continue;
          float m[LC];
          run_sum<LC>(s_ids, n, sorted, id, qv, L, c0, nc, m);
#pragma unroll
          for (int c = 0; c < LC; ++c) acc[c] += v * m[c];
        }
#pragma unroll
        for (int c = 0; c < LC; ++c) acc[c] = warp_sum(acc[c]);
        if (lane == 0) {
          float* o = out + (size_t)r * L + c0;
#pragma unroll
          for (int c = 0; c < LC; ++c)
            if (c < nc) o[c] = (t == 0) ? acc[c] : o[c] + acc[c];
        }
      }
    }
  }
}

template <class Docs, int LC>
__global__ void __launch_bounds__(kThreads)
match_kernel(Docs docs, int D, int K, const int* __restrict__ q_ids,
             const float* __restrict__ q_vals, int Qm, int L,
             float* __restrict__ out, int rows_per_block) {
  extern __shared__ int s_ids[];
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(D, r0 + rows_per_block);
  match_rows<Docs, LC>(docs, K, q_ids, q_vals, Qm, L, out, r0, r1, s_ids);
}

constexpr int kRowsPerBlock = 256;

template <class Docs>
int launch_match(int device, const Docs& docs, int D, int K,
                 const int* q_ids, const float* q_vals, int Qm, int L,
                 float* out, cudaStream_t stream) {
  if (D <= 0 || L <= 0) return (int)cudaSuccess;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (D + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem =
      sizeof(int) * (size_t)std::max(1, std::min(Qm, kMaxTileItems));
  return with_pass_cols(L, [&](auto lc) {
    match_kernel<Docs, decltype(lc)::value><<<blocks, kThreads, smem,
                                              stream>>>(
        docs, D, K, q_ids, q_vals, Qm, L, out, kRowsPerBlock);
    return (int)cudaGetLastError();
  });
}

}  // namespace rsm
"""
NAMESPACE_END = "}  // namespace rsm\n"
FIRST_DESIGN_B1 = {
    "match.cuh": [(NAMESPACE_END, FIRST_DESIGN)],
    "sparse_match.cu": [(
        "  return rsm::launch_table(device, rsm::EllDocs{doc_ids, doc_vals}, "
        "D, K,\n", "  return rsm::launch_match(device, rsm::FirstDesignEll{"
        "doc_ids, doc_vals}, D, K,\n")]}
FIRST_DESIGN_B2 = {
    "match.cuh": [(NAMESPACE_END, FIRST_DESIGN)],
    "sparse_match_packed.cu": [(
        "  return rsm::launch_table(device, rsm::PackedDocs{docs_packed}, D, "
        "K, q_ids,\n", "  return rsm::launch_match(device, "
        "rsm::FirstDesignPacked{docs_packed}, D, K, q_ids,\n")]}

# name -> (library, {file: [(line, what it becomes), ...]})
VARIANTS = {
    "B1 constant miss": ("sparse_match",
                         {"match.cuh": [(TABLE_LOOKUP, TABLE_MISS)]}),
    "B1 hits add nothing": ("sparse_match", {"match.cuh": [(HIT, NO_HIT)]}),
    "B1 runs walked": ("sparse_match", {"match.cuh": [WALK]}),
    "B1 value read only on a hit": ("sparse_match", ON_HIT),
    "B1 registers not capped for four blocks an SM": (
        "sparse_match", {"match.cuh": [UNCAPPED]}),
    "B1 query tile at its least": ("sparse_match",
                                   {"match.cuh": [LEAST_TILE]}),
    "B1 binary search (the first design)": ("sparse_match", FIRST_DESIGN_B1),
    "B1 two slots in flight a lane": ("sparse_match", {
        "match.cuh": [TWO_AHEAD, TWO_AHEAD_TAIL]}),
    "B1 two slots in flight a lane, registers not capped": (
        "sparse_match", {"match.cuh": [TWO_AHEAD, TWO_AHEAD_TAIL,
                                       UNCAPPED]}),
    "B2 constant miss": ("sparse_match_packed",
                         {"match.cuh": [(TABLE_LOOKUP, TABLE_MISS)]}),
    "B2 runs walked": ("sparse_match_packed", {"match.cuh": [WALK]}),
    **{f"B2 passes of at least {c} columns, else walks": (
        "sparse_match_packed", {"match.cuh": [(
            "constexpr int kMinPassCols = 4;",
            f"constexpr int kMinPassCols = {c};")]})
       for c in (1, 2, 8)},
    "B2 registers not capped for four blocks an SM": (
        "sparse_match_packed", {"match.cuh": [UNCAPPED]}),
    "B2 query tile at its least": ("sparse_match_packed",
                                   {"match.cuh": [LEAST_TILE]}),
    "B2 binary search (the first design)": ("sparse_match_packed",
                                            FIRST_DESIGN_B2),
    "B2 two slots in flight a lane": ("sparse_match_packed", {
        "match.cuh": [TWO_AHEAD, TWO_AHEAD_TAIL]}),
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


def build_variants(out_dir: Path, baseline=None) -> dict:
    """{variant: path of its built library}, and {"baseline <lib>": ...}
    for each library built from the sources of the checkout ``baseline``;
    raises if an edit misses. Prints each build's most registers and any
    spills (ptxas)."""
    jobs = {name: (lib, _build.CSRC, edits)
            for name, (lib, edits) in VARIANTS.items()}
    if baseline is not None:
        csrc = Path(baseline) / "src" / "repro_torch" / "kernels" / "csrc"
        for lib in sorted({lib for lib, _ in VARIANTS.values()}):
            jobs[f"baseline {lib}"] = (lib, csrc, {})
    procs = {}
    for i, (name, (lib, csrc, edits)) in enumerate(jobs.items()):
        d = out_dir / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for src in ("match.cuh", f"{lib}.cu"):
            text = (csrc / src).read_text()
            for old, new in edits.get(src, []):
                if text.count(old) != 1:
                    raise RuntimeError(f"variant {name!r}: its line is not "
                                       f"in {src} once")
                text = text.replace(old, new)
            (d / src).write_text(text)
        so = d / f"{lib}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{csrc}",
             "-o", str(so), str(d / f"{lib}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                             log)]
        print(f"built {name}: at most {max(regs, default=0)} registers, "
              f"{sum(spills)} bytes of spill stores", flush=True)
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
    ap.add_argument("--L", type=int, nargs="+", default=[8],
                    help="which of chip_smoke's requests (L = 1..8) to "
                         "time at the main shape")
    ap.add_argument("--query-nnz", type=int, nargs="+", default=[],
                    help="also time L = 8 requests of queries of this "
                         "many distinct ids")
    ap.add_argument("--only", nargs="+", default=None,
                    help="run only the variants whose names hold one of "
                         "these strings")
    ap.add_argument("--baseline", default=None,
                    help="the root of another checkout (the parent, by "
                         "git archive): its kernels are timed first and "
                         "last, around the ones built here")
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
    libs = build_variants(_build.BUILD_DIR.parent / "variants",
                          args.baseline)

    cfg = SearchConfig(name="paper-full")
    corpus = corpus_lib.synthesize(args.docs, cfg.vocab_size,
                                   cfg.avg_nnz_per_doc, cfg.nnz_pad,
                                   seed=chip_smoke.SEED)
    rng = np.random.default_rng(chip_smoke.SEED)
    requests = []
    for L in range(1, 9):                  # chip_smoke's requests
        idx = rng.integers(0, args.docs, L)
        if L in args.L:
            qs = [corpus_lib.make_query(corpus, int(i), cfg.max_query_nnz)
                  for i in idx]
            requests.append(("main" if L == 8 else f"main L={L}",
                             np.stack([q[0] for q in qs]),
                             np.stack([q[1] for q in qs])))
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
        plans = {
            "B1": query_tiles(mi, MAX_KEY, min_cols=MIN_PASS_COLS,
                              tile_bytes=tile_bytes(dev, mi.size, Lp))[0],
            "B2": query_tiles(mi, (1 << 20) - 1, min_cols=MIN_PASS_COLS,
                              tile_bytes=b2.tile_bytes(dev, mi.size, Lp))[0],
            "B3": query_tiles(mi, fused.KEY_MASK)[0]}
        print(f"request {request}: L={Lp} Qm={mi.size} "
              f"real={plans['B3']['real']} "
              f"distinct={plans['B3']['distinct']} "
              + " ".join(f"{k} slots={t['slots']} sums={t['sum_cols']}"
                         for k, t in plans.items()), flush=True)
        calls = {
            "sparse_match": lambda: sparse_match(g.d_ids, g.d_vals, q_ids,
                                                 q_vals),
            "sparse_match_packed": lambda: b2.sparse_match_packed(
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
            if args.baseline:
                base = libs[f"baseline {lib}"]
                runs = ([("baseline", base)] + runs
                        + [("baseline, again", base)])
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
