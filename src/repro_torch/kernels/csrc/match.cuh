// Device code shared by the three search kernels (sparse_match.cu, B1;
// sparse_match_packed.cu, B2; fused.cu, B3): the merged query stream held
// in shared memory tile by tile (8192 ids a tile), the lookup of the run
// of query items that carry one word id, and the persistent loop over doc
// rows that B1 and B2 run (table_kernel). It replaces the match matrix
// eq[d*k, q] = (doc_id == q_id) that the TPU kernels
// (src/repro/kernels/sparse_match.py, sparse_match_packed.py, fused.py)
// multiply on the MXU. Each kernel's bound is in its own note (bytes: the
// doc words read once, 0.16-0.24 ms at 2^20 docs on the H100); this file
// decides what each doc word costs on top of its bytes.
//
// The merged stream (kernels/ops.py) is the real ids in ascending order
// followed by query pads (-2): sorted under "pads sort last". The first
// design binary-searched the whole tile for every doc word: 12 dependent
// shared loads at Qm = 4096, each a warp-wide gather with bank conflicts,
// though an L = 8 request holds ~400 real items (~350 distinct ids) in
// its 4096 and only ~22% of doc words hit. B1 and B2 took 1.58-1.66 ms
// that way, ~0.9-1.0 of it B1's lookups and run walks (H100 80GB HBM3,
// 700 W; benchmarks/port_match_variants.py carries that design's loop as
// text and times it beside this one).
//
// The lookup is a hashed table of the query tile's distinct ids in shared
// memory (QueryTile):
//  - built by the block from the sorted tile, over the tile's pads, once a
//    query tile: one 16-bit slot a distinct id, holding the start of its
//    run; the key is the id at that start;
//  - sized from the tile's real items (the first pad bounds them), not
//    from Qm, after the run sums below (table_plan): the least power of
//    two >= 4 x real items (load <= 1/4) where that fits, else >= 2 x
//    (load <= 1/2, which always fits beside the ids); an L = 8 request
//    puts ~350 keys in 2048 slots (4 KB), a tile of 8192 distinct ids
//    fills 8192 of 16384 (32 KB). Load 1/4 against 1/2: B2 0.60-0.63
//    against 0.71 ms, B3 0.75-0.80 against 0.90 (variants, same card);
//  - a Fibonacci hash with linear probing: a miss ends at an empty slot,
//    so most doc words pay one shared load, not 12;
//  - holding only ids the doc format can carry (every non-negative int32
//    for B1's ELL ids, below 2^20 for B2's words, at most 2^19 - 1 for
//    B3's): the others never match. The hash takes any 32-bit id, and a
//    slot holds a run start, below 8192, whatever the id;
//  - placed with a 16-bit shared atomicCAS: placement, not a sum. Each
//    distinct id is inserted once, so a lookup finds the same start
//    whatever the insertion order.
// A hit adds its run's value rows summed in stream order. Walking the run
// from its start puts a dependent global load a hit on the critical path
// (B2 at the main request: 1.30 ms walking against 0.60-0.63; with four
// words a lane 2.21, slower than the binary search's 1.60), so the block
// sums every run once a column pass (sum_runs, the plain version's
// `runs`), in the same order, into shared memory after the table: a hit
// then reads one row of at most 8 floats. The sums take 4 bytes a column
// a real item (13 KB at L = 8 for the main request), and table_plan gives
// them room before it gives the table load 1/4. B3's query tile has
// query_tile_smem(Qm) (32 KB at Qm = 4096), and its passes stay 8 columns
// wide. B1's and B2's take the shared memory their registers leave
// (smem_share: 56 KB a block at four blocks an SM), and where the sums of
// 8 columns still do not fit, their column passes narrow to 4 (each pass
// a sweep of the docs; narrower ones lost to walking). Where no sums fit,
// hits walk their runs: at 512 ids a query (4096 real items) B2 takes
// 2.84-2.86 ms and B3 2.77-2.78, against 3.56 for B2's first design
// (sparse_match_packed.cu has the crossovers). A bitmap with ranks over
// the 2^19-2^20 id space would need 64-128 KB a block, or a two-level
// index, to answer what 4 KB of table answers here. A tile that is not
// sorted under "pads sort last" builds no table and is scored by the
// full-tile scan, exactly, as before.
//
// B1 and B2 differ only in how a slot is read (a doc reader: ELL ids and
// values from two arrays, or packed words), and run one loop, table_kernel:
// persistent blocks, as many as the card holds at once; each warp strides
// over rows, one slot a lane, the warp's next load issued before this
// slot's lookup and streamed past L1 (__ldcs) so that the query rows stay
// there; a row's column sums leave the warp by a transposed shuffle tree.
// The design choices and their times are in sparse_match_packed.cu (B2,
// which they were measured on first) and sparse_match.cu (B1).
//
// Numerics: sums are taken in a fixed order (run items in stream order,
// then a lane's slots in order, then one warp's lanes by a fixed shuffle
// tree, then query tiles in order), never with atomics, so a launch is
// deterministic; integral counts are exact in any order, so they agree
// bit for bit with the plain versions. A miss adds value x 0, which is
// nothing unless the value is not finite (B1's float values: then NaN, as
// in the plain version). The build uses IEEE division and square root and
// no FMA contraction (no --use_fast_math, -fmad=false).
#pragma once

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "error.cuh"

namespace rsm {

constexpr int kThreads = 256;              // 8 warps a block (B1, B2)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileItems = 8192;        // query ids a tile (32 KB smem)
constexpr int kMaxCols = 8;                // value columns a pass accumulates
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kPadWord = 0xffffffffu; // packed-word pad (Fig. 8)
constexpr uint32_t kHeaderBit = 0x80000000u;
constexpr int kValBits = 12;
constexpr uint32_t kValMask = (1u << kValBits) - 1;
constexpr uint32_t kKeyMask = (1u << 19) - 1;
constexpr uint32_t kMaxDocId = 0x7fffffffu;
constexpr int kEmpty = 0xffff;             // an empty table slot
constexpr int kMinSlots = 64;
constexpr size_t kReservedSmem = 1024;     // shared memory the card keeps a block

// Query pads (any negative id) sort after every real id.
__device__ __forceinline__ int qkey(int id) { return id < 0 ? INT_MAX : id; }

// The sum over W lanes (the warp, or each of its halves) of each of LC
// columns in fewer shuffles than LC butterflies: log2(LC) halving steps
// (a lane keeps half of its columns and adds its partner's partials of
// them), then plain butterfly steps; 9 shuffles for 8 columns over 32
// lanes, not 40. Every lane ends with the whole sum of column
// col_of<LC, W>(lane); the lanes with write_lane<LC, W>(lane) hold one
// column each. The sum order is fixed, so a launch is deterministic.
template <int LC, int W = 32>
__device__ __forceinline__ float warp_sum_cols(float (&x)[LC], int lane) {
#pragma unroll
  for (int n = LC, o = W / 2; n > 1; n >>= 1, o >>= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? x[i] : x[i + n / 2];
      const float keep = upper ? x[i + n / 2] : x[i];
      x[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
#pragma unroll
  for (int o = W / 2 / LC; o > 0; o >>= 1)
    x[0] += __shfl_xor_sync(kFull, x[0], o);
  return x[0];
}

template <int LC, int W = 32>
__device__ __forceinline__ int col_of(int lane) {
  int c = 0;
#pragma unroll
  for (int n = LC, o = W / 2; n > 1; n >>= 1, o >>= 1)
    if (lane & o) c += n / 2;
  return c;
}

template <int LC, int W = 32>
__device__ __forceinline__ bool write_lane(int lane) {
  return (lane & (W / LC - 1)) == 0;
}

// Query tile count: at least one, so an empty stream still scores (every
// document then gets 0 * its values, as a tile of pads gives).
__host__ __device__ __forceinline__ int n_query_tiles(int Qm) {
  return Qm <= 0 ? 1 : (Qm + kMaxTileItems - 1) / kMaxTileItems;
}

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// The least power of two >= x, at least kMinSlots.
__host__ __device__ __forceinline__ int pow2_slots(int x) {
  int s = kMinSlots;
  while (s < x) s <<= 1;
  return s;
}

// Items of the largest query tile of a stream of Qm items (at least 1).
__host__ __device__ __forceinline__ int tile_items(int Qm) {
  return Qm < 1 ? 1 : (Qm < kMaxTileItems ? Qm : kMaxTileItems);
}

// Shared memory of a QueryTile for a stream of Qm items: a word of
// scratch, then its ids and a table at load 1/2 for a tile of that many
// distinct ids. It is the least a QueryTile takes (B3's, and B2's unless
// its registers leave more), all of it dynamic shared memory.
__host__ __device__ __forceinline__ size_t query_tile_smem(int Qm) {
  const int n = tile_items(Qm);
  return 16 + align16(sizeof(int) * (size_t)n) +
         align16(sizeof(uint16_t) * (size_t)pow2_slots(2 * n));
}

// Whether n real ids, a table of `slots` and the run sums of `cols`
// columns fit in `bytes`.
__host__ __device__ __forceinline__ bool plan_fits(int n, int slots, int cols,
                                                   size_t bytes) {
  return align16(sizeof(int) * (size_t)n) +
             align16(sizeof(uint16_t) * (size_t)slots) +
             sizeof(float) * (size_t)cols * n <=
         bytes;
}

struct TablePlan {
  int slots, cols;                         // cols 0: hits walk their runs
};

// The table and the run sums of a sorted tile of n real items in a
// QueryTile of `bytes` (kernels/sparse_match.py::table_plan is the same
// rule): the widest sums of lc, lc / 2, ... down to min_cols columns that
// fit, beside a table at load 1/4 where that fits too, else at load 1/2;
// if none fit, no sums, and the table at load 1/4 where it fits beside
// the ids, else at load 1/2 (which always fits).
__host__ __device__ __forceinline__ TablePlan table_plan(int n, size_t bytes,
                                                         int lc,
                                                         int min_cols) {
  const int quarter = pow2_slots(4 * n), half = pow2_slots(2 * n);
  for (int c = lc; c >= min_cols && c > 0; c >>= 1) {
    if (plan_fits(n, quarter, c, bytes)) return {quarter, c};
    if (plan_fits(n, half, c, bytes)) return {half, c};
  }
  return {plan_fits(n, quarter, 0, bytes) ? quarter : half, 0};
}

// The value columns [c0, c0 + nc) of the query rows of one tile.
struct QueryCols {
  const float* __restrict__ qv;            // the tile's first row, [*, L]
  int L, c0, nc;
};

// m[c] += row p's value in column c0 + c (c < nc).
template <int LC>
__device__ __forceinline__ void add_row(float (&m)[LC], const QueryCols& q,
                                        int p) {
  const float* row = q.qv + (size_t)p * q.L + q.c0;
#pragma unroll
  for (int c = 0; c < LC; ++c)
    if (c < q.nc) m[c] += __ldg(row + c);
}

// LC floats from shared memory at p (16-byte aligned rows when LC % 4 == 0).
template <int LC>
__device__ __forceinline__ void load_cols(float (&m)[LC], const float* p) {
  if constexpr (LC % 4 == 0) {
#pragma unroll
    for (int c = 0; c < LC; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c);
      m[c] = x.x;
      m[c + 1] = x.y;
      m[c + 2] = x.z;
      m[c + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < LC; ++c) m[c] = p[c];
  }
}

// One query tile in shared memory: its ids and, when it is sorted, its
// table and, where they fit, the summed value rows of its runs.
struct QueryTile {
  int* first_pad;                          // scratch of load()
  unsigned char* base;                     // ids, then table and sums
  size_t bytes;                            // from base
  int* ids;                                // [n]
  uint16_t* tab;                           // [mask + 1], over the pads
  const float* rs;                         // [n_real, cols] by run start, or null
  int n, n_real, mask, shift;
  int cols;                                // columns of the run sums (0: none)
  uint32_t max_key;
  bool sorted;

  // A QueryTile in `bytes` (>= query_tile_smem(Qm)) of shared memory.
  __device__ static QueryTile at(unsigned char* smem, size_t bytes) {
    QueryTile qt;
    qt.first_pad = reinterpret_cast<int*>(smem);
    qt.base = smem + 16;
    qt.bytes = bytes - 16;
    qt.ids = reinterpret_cast<int*>(qt.base);
    qt.rs = nullptr;
    return qt;
  }

  __device__ __forceinline__ uint32_t home(int id) const {
    return ((uint32_t)id * 0x9E3779B1u) >> shift;
  }

  // Load query tile t and, if it is sorted, build its table of the ids
  // <= max_key over the tile's pads, planned for run sums of lc down to
  // min_cols columns (table_plan). Every thread of the block calls it; it
  // starts and ends with a barrier.
  __device__ void load(const int* __restrict__ q_ids, int Qm, int t,
                       uint32_t max_key_, int lc, int min_cols) {
    const int t0 = t * kMaxTileItems;
    n = max(0, min(kMaxTileItems, Qm - t0));
    max_key = max_key_;
    rs = nullptr;
    cols = 0;
    __syncthreads();                       // the previous tile is done
    if (threadIdx.x == 0) *first_pad = n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) ids[i] = q_ids[t0 + i];
    __syncthreads();
    int ok = 1;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int q = ids[i];
      if (i + 1 < n) ok &= qkey(q) <= qkey(ids[i + 1]);
      // the first pad of a sorted tile bounds its real items
      if (q < 0 && (i == 0 || ids[i - 1] >= 0)) *first_pad = i;
    }
    sorted = __syncthreads_and(ok) != 0;
    if (!sorted) return;
    n_real = *first_pad;
    tab = reinterpret_cast<uint16_t*>(base + align16(sizeof(int) * n_real));
    const TablePlan plan = table_plan(n_real, bytes, lc, min_cols);
    cols = plan.cols;
    mask = plan.slots - 1;
    shift = 32 - (__ffs(plan.slots) - 1);
    uint32_t* words = reinterpret_cast<uint32_t*>(tab);
    for (int i = threadIdx.x; i < plan.slots / 2; i += blockDim.x)
      words[i] = 0xffffffffu;              // two empty slots
    __syncthreads();
    for (int i = threadIdx.x; i < n_real; i += blockDim.x) {
      const int id = ids[i];
      if ((uint32_t)id > max_key || (i > 0 && ids[i - 1] == id)) continue;
      uint32_t h = home(id);               // id's run starts at i
      while (atomicCAS(tab + h, (uint16_t)kEmpty, (uint16_t)i) != kEmpty)
        h = (h + 1) & mask;
    }
    __syncthreads();
  }

  // m[c] += the value rows of id's run from its start s, in stream order.
  template <int LC>
  __device__ __forceinline__ void run(int id, int s, const QueryCols& q,
                                      float (&m)[LC]) const {
    do add_row<LC>(m, q, s);
    while (++s < n_real && ids[s] == id);
  }

  // m[c] += the value rows of every item carrying id (any tile order).
  template <int LC>
  __device__ __forceinline__ void scan(int id, const QueryCols& q,
                                       float (&m)[LC]) const {
    for (int p = 0; p < n; ++p)
      if (ids[p] == id) add_row<LC>(m, q, p);
  }

  // Where load() planned run sums (cols > 0; q.nc <= cols): each run's
  // value rows in columns q.c0.. summed in stream order (what run() adds
  // up), stored at its start, so that a hit reads one row and walks
  // nothing. Else rs stays null and hits walk their runs. Every thread of
  // the block calls it; it starts and ends with a barrier.
  template <int LC>
  __device__ void sum_runs(const QueryCols& q) {
    __syncthreads();                       // the previous sums are done
    rs = nullptr;
    if (!cols) return;
    float* sums = reinterpret_cast<float*>(
        base + align16(sizeof(int) * n_real) +
        align16(sizeof(uint16_t) * (mask + 1)));
    for (int i = threadIdx.x; i < n_real; i += blockDim.x) {
      const int id = ids[i];
      if ((uint32_t)id > max_key || (i > 0 && ids[i - 1] == id)) continue;
      float m[LC];
#pragma unroll
      for (int c = 0; c < LC; ++c) m[c] = 0.f;
      run<LC>(id, i, q, m);
#pragma unroll
      for (int c = 0; c < LC; ++c)
        if (c < cols) sums[(size_t)i * cols + c] = m[c];
    }
    __syncthreads();
    rs = sums;
  }
};

// acc[c] += v[j] * (sum of the query rows carrying id[j]) for a lane's NW
// doc words in order (ok[j]: the word is a pair, not a pad). On a sorted
// tile the NW home slots are read first, then the NW keys, so the common
// case is two independent rounds of shared loads; probing past a taken
// slot is the rare case. A hit then reads its run's summed row (columns
// past qt.cols read 0), or walks the run where no sums fit. A miss adds
// v * 0: +0, nothing, unless FloatVals and v is not finite (NaN).
template <int LC, int NW, bool FloatVals = false>
__device__ __forceinline__ void match_words(const QueryTile& qt,
                                            const QueryCols& q,
                                            const int (&id)[NW],
                                            const float (&v)[NW],
                                            const bool (&ok)[NW],
                                            float (&acc)[LC]) {
  int s[NW];
  if (qt.sorted) {
    uint32_t h[NW];
    int key[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      h[j] = qt.home(id[j]);
      s[j] = ok[j] ? qt.tab[h[j]] : kEmpty;   // the lookup
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) key[j] = s[j] != kEmpty ? qt.ids[s[j]] : id[j];
#pragma unroll
    for (int j = 0; j < NW; ++j)
      while (s[j] != kEmpty && key[j] != id[j]) {
        h[j] = (h[j] + 1) & qt.mask;
        s[j] = qt.tab[h[j]];
        key[j] = s[j] != kEmpty ? qt.ids[s[j]] : id[j];
      }
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    if (!ok[j] || (qt.sorted && s[j] == kEmpty)) {   // a pad or a miss
      if constexpr (FloatVals)
        if (ok[j] && !isfinite(v[j]))
#pragma unroll
          for (int c = 0; c < LC; ++c) acc[c] += v[j] * 0.f;
      continue;
    }
    float m[LC];
    if (qt.rs) {
      if (qt.cols == LC) {
        load_cols<LC>(m, qt.rs + (size_t)s[j] * LC);
      } else {                             // narrower passes (B1, B2)
#pragma unroll
        for (int c = 0; c < LC; ++c)
          m[c] = c < qt.cols ? qt.rs[(size_t)s[j] * qt.cols + c] : 0.f;
      }
    } else {
#pragma unroll
      for (int c = 0; c < LC; ++c) m[c] = 0.f;
      if (qt.sorted)
        qt.run<LC>(id[j], s[j], q, m);
      else
        qt.scan<LC>(id[j], q, m);
    }
#pragma unroll
    for (int c = 0; c < LC; ++c) acc[c] += v[j] * m[c];
  }
}

// Host side: how many blocks of `kernel` (with `smem` bytes of dynamic
// shared memory, opted in for every size: the kernel's static shared
// memory counts against the same 48 KB default) the card holds at once,
// for a persistent grid. 0 on an error, which the launch then reports.
template <class Kernel>
int resident_blocks(int device, Kernel kernel, int threads, size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
}

// Host side: the dynamic shared memory a block of `kernel` may take
// without lowering how many blocks an SM holds with `need` bytes (its
// registers or threads may bound that first): the SM's shared memory
// over those blocks, at least `need`, at most the card's limit a block.
// 0 on an error, which the launch then reports.
template <class Kernel>
size_t smem_share(int device, Kernel kernel, int threads, size_t need) {
  int optin = 0, per_sm = 0, blocks = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm,
                             cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             device) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    need) != cudaSuccess ||
      blocks <= 0)
    return 0;
  const size_t share = (size_t)per_sm / blocks - kReservedSmem;
  return std::max(need, std::min((size_t)optin, share));
}

// The column pass width for L value columns.
__host__ __device__ __forceinline__ int pass_cols(int L) {
  return L == 1 ? 1 : L == 2 ? 2 : L <= 4 ? 4 : kMaxCols;
}

// Host side: f(std::integral_constant<int, LC>{}) for L's pass width LC.
template <class F>
auto with_pass_cols(int L, F&& f) {
  switch (pass_cols(L)) {
    case 1:
      return f(std::integral_constant<int, 1>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    case 4:
      return f(std::integral_constant<int, 4>{});
    default:
      return f(std::integral_constant<int, kMaxCols>{});
  }
}

constexpr int kMinPassCols = 4;            // narrower passes: hits walk

// The persistent loop of B1 and B2 over the rows of a [D, K] doc matrix
// read by `Docs`, which gives
//   Slot, load(r, k, D, K)    what a lane loads of slot k of row r (a pad
//                             outside the matrix), streamed past L1;
//   word(slot, r, k, K, id, v, ok)  its word id, value and whether it is
//                             a word, not a pad;
//   kMaxKey                   the largest id a slot carries;
//   kFloatVals                values may be any float, not only counts;
//   kBlocksPerSm              the blocks an SM its registers are capped for.
// out[r, c] = sum_k v[r, k] * (sum of the query rows carrying id[r, k]):
// query tile by query tile, each a table (QueryTile::load) and column
// passes as wide as its run sums (LC, or down to kMinPassCols, where the
// sums of LC do not fit), each pass one sweep of the rows.
template <class Docs, int LC>
__global__ void __launch_bounds__(kThreads, Docs::kBlocksPerSm)
table_kernel(Docs docs, int D, int K, const int* __restrict__ q_ids,
             const float* __restrict__ q_vals, int Qm, int L,
             size_t tile_bytes, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  QueryTile qt = QueryTile::at(smem, tile_bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = blockIdx.x * kWarps + warp;   // this warp's first row
  const int stride = gridDim.x * kWarps;
  const int chunks = max(1, (K + 31) / 32);       // loads a row
  const int nt = n_query_tiles(Qm);
  for (int t = 0; t < nt; ++t) {
    qt.load(q_ids, Qm, t, Docs::kMaxKey, LC, min(LC, kMinPassCols));
    const int w = qt.cols ? qt.cols : LC;         // this tile's pass width
    for (int c0 = 0; c0 < L; c0 += w) {
      const QueryCols q{q_vals + (size_t)t * kMaxTileItems * L, L, c0,
                        min(w, L - c0)};
      qt.sum_runs<LC>(q);
      float acc[LC];
#pragma unroll
      for (int c = 0; c < LC; ++c) acc[c] = 0.f;
      int r = first, c = 0;
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
          const float sum = warp_sum_cols<LC>(acc, lane);
          const int col = col_of<LC>(lane);
          if (write_lane<LC>(lane) && col < q.nc) {
            float* o = out + (size_t)r * L + c0 + col;
            *o = (t == 0) ? sum : *o + sum;
          }
#pragma unroll
          for (int j = 0; j < LC; ++j) acc[j] = 0.f;
        }
        r = nr;
        c = nc;
        slot = next;
      }
    }
  }
}

// Host side: the dynamic shared memory of a launch, its query tile: what
// the kernel's registers leave a block, at least query_tile_smem(Qm).
template <class Docs, int LC>
size_t table_smem(int device, int Qm) {
  return smem_share(device, table_kernel<Docs, LC>, kThreads,
                    query_tile_smem(Qm));
}

// Host side: table_smem for L columns on card `device` (0 on an error).
template <class Docs>
int table_smem_bytes(int device, int Qm, int L) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  return (int)with_pass_cols(L, [&](auto lc) {
    return table_smem<Docs, decltype(lc)::value>(device, Qm);
  });
}

// Host side: launch table_kernel on `stream` of card `device` (this
// library's CUDA runtime keeps its own current device, so it is set from
// the caller's tensors on every launch); returns cudaGetLastError().
template <class Docs>
int launch_table(int device, const Docs& docs, int D, int K,
                 const int* q_ids, const float* q_vals, int Qm, int L,
                 float* out, cudaStream_t stream) {
  if (D <= 0 || L <= 0) return (int)cudaSuccess;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return with_pass_cols(L, [&](auto lc) {
    constexpr int LC = decltype(lc)::value;
    const size_t smem = table_smem<Docs, LC>(device, Qm);
    const int resident =
        smem ? resident_blocks(device, table_kernel<Docs, LC>, kThreads, smem)
             : 0;
    if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
    const int blocks = std::min(resident, (D + kWarps - 1) / kWarps);
    table_kernel<Docs, LC><<<blocks, kThreads, smem, stream>>>(
        docs, D, K, q_ids, q_vals, Qm, L, smem, out);
    return (int)cudaGetLastError();
  });
}

}  // namespace rsm
