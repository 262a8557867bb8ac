// Fused decode + match + per-tile top-k: the port's backend "gpu_fused" (B3).
//
// Replaces src/repro/kernels/fused.py::_fused_kernel (backend
// "pallas_fused"). Input is the Fig. 8 stream cut into [T, cap] uint32 doc
// tiles (cap = block_docs * (1 + nnz_pad), pad 0xFFFFFFFF) and the merged
// query stream; output is each tile's best kp rows per query column,
// [T, L, kp] scores and doc ids. Only those leave the block.
//
// Bound on the H100: bytes. At 2^20 docs x nnz_pad 128 the tiles are
// 8192 x 16512 words = 0.54 GB, read once: 0.164 ms at 3.35 TB/s with
// the queries and candidates (a few MB). Pads may sit anywhere in a tile,
// so every word is read.
//
// The first design took 3.40 ms (H100 80GB HBM3, 700 W; the times below
// are benchmarks/port_match_variants.py on that card at the main shape,
// L = 8, Qm = 4096). It read each 66 KB tile three times (header scan,
// norms, match; the second and third through L1/L2), its header scan took
// two block barriers every 256 words (130 a tile), each word's lookup was
// a 12-step binary search, and each of its 8192 blocks
// reloaded and re-checked the query tile. Here each tile is read from
// device memory once, into shared memory, and every later read is a
// shared load:
//  - Staging: blocks of 256 threads are persistent and walk tiles
//    blockIdx.x, + grid, ...; a tile's words arrive by 1-D bulk copies
//    (cp.async.bulk, completion counted on an mbarrier; no tensor map).
//    The words before the tile's first and after its last 16-byte
//    boundary (a bulk copy moves whole 16-byte units) are copied by
//    threads; the tile sits in its stage at its global address mod 16, so
//    any cap works. At the main shape one stage (66,064 bytes), the query
//    tile with its table and run sums (32 KB at Qm = 4096), s_corr
//    [8 x 128] and the row arrays come to 104.6 KB, so two blocks share an
//    SM: while one waits for its copy or runs its epilogue, the other
//    matches, and the next tile's copy starts as soon as the last column
//    pass has matched, under this tile's epilogue. Two stages (the next
//    tile's copy under this tile's match) fit one block of 170 KB an SM,
//    which was much slower (1.34 ms), so a block has one stage
//    (fused_match_topk_stages), or none where the tile and the rest do
//    not fit a block: the tile is then read from device memory where the
//    same code reads the stage (at the main shape that is 1.13 ms). The
//    copy alone takes 0.22-0.23 ms, 0.72-0.73 of the bound's rate.
//  - Header scan: each warp scans its own contiguous range of the tile,
//    128 words a step, counting its headers and its last word that is not
//    a pad (a step of pads only costs one vote); one block barrier and an
//    8-entry prefix give each warp its first row, and a second sweep of
//    the range, which stops at the tile's last word that is not a pad,
//    places the rows with ballot and popc; rows past block_docs drop. The
//    last row ends after that word, so a tile's trailing pads are not
//    walked. The scan adds 0.07-0.09 ms to the copy.
//  - One sweep per row, half a warp a row: the norm's squared counts and
//    the lookup of every word by the query table of match.cuh, two words
//    a lane a step; a row's 8 column sums and its norm leave the half
//    warp by a transposed shuffle tree into s_corr [LC, bd].
//  - The query tile, its table and its run sums are built once per block
//    when the stream is one query tile and one column pass (Qm <= 8192,
//    L <= 8: the main path), not once per doc tile. Longer streams
//    rebuild them per doc tile, query tile by query tile in order; L > 8
//    runs column passes of 8, each with its own epilogue, so shared
//    memory does not grow with L.
//  - Epilogue: the cosine (-inf where the denominator is <= 0 or the row
//    is a pad) and, per column, the best kp rows, ranking NaN as +inf and
//    breaking ties to the lower row, as the Pallas epilogue's lax.top_k
//    does. A round takes the warp's best row by two redux.sync (the
//    largest key, then the lowest row holding it). With at most 128 rows
//    a tile each lane keeps its four rows sorted in registers and the
//    round's winner shifts its list (0.02-0.08 ms of the kernel;
//    rescanning the lane's rows in shared memory, as more rows a tile
//    do, 0.16-0.21 ms).
#include <cmath>

#include "match.cuh"

namespace rsm {

constexpr int kFusedThreads = 256;         // 8 warps a block
constexpr int kFusedWarps = kFusedThreads / 32;
constexpr int kMaxTileRows = 1024;         // 32 lanes x 32 bits of "taken"
constexpr int kWordsPerLane = 2;           // a row's words a lane takes a step
constexpr uint32_t kCopyPiece = 1u << 15;  // bytes a bulk copy instruction

__device__ __forceinline__ bool is_header(uint32_t w) {
  return (w & kHeaderBit) && w != kPadWord;
}
__device__ __forceinline__ bool is_pair(uint32_t w) {
  return w != kPadWord && !(w & kHeaderBit);
}

// The rank the Pallas epilogue sorts by (NaN -> +inf), as an int whose
// order is the floats' total order (lax.top_k's comparator).
__device__ __forceinline__ int rank_key(float x) {
  if (isnan(x)) x = INFINITY;
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// Byte offsets into the block's dynamic shared memory.
struct FusedLayout {
  size_t stage_bytes, tile, query, corr, norm, docid, start, count, bytes;
};

// `staged`: with the tile's stage (else the tile is read from device
// memory).
__host__ __device__ __forceinline__ FusedLayout fused_layout(int cap, int bd,
                                                             int Qm, int L,
                                                             bool staged) {
  FusedLayout f;
  // a tile sits at its global address mod 16: up to 3 words of shift
  f.stage_bytes = align16(sizeof(uint32_t) * ((size_t)cap + 3));
  f.tile = 16;                             // after the 8-byte mbarrier
  f.query = f.tile + (staged ? f.stage_bytes : 0);
  f.corr = f.query + query_tile_smem(Qm);
  f.norm = f.corr + align16(sizeof(float) * (size_t)bd * pass_cols(L));
  f.docid = f.norm + align16(sizeof(float) * (size_t)bd);
  f.start = f.docid + align16(sizeof(int) * (size_t)bd);
  f.count = f.start + align16(sizeof(int) * ((size_t)bd + 1));
  f.bytes = f.count + 2 * sizeof(int) * kFusedWarps;
  return f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// Thread 0: start the copy of tile `g` (cap words) into the stage at
// `stage`; the stage's mbarrier completes when the bytes have landed.
// Only whole 16-byte units move; copy_edges moves the rest.
__device__ __forceinline__ void issue_tile(uint64_t* bar,
                                           unsigned char* stage,
                                           const uint32_t* g, int cap) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  const uintptr_t lo = (a + 15) & ~(uintptr_t)15;
  const uintptr_t hi = (a + sizeof(uint32_t) * (size_t)cap) & ~(uintptr_t)15;
  const uint32_t bytes = hi > lo ? (uint32_t)(hi - lo) : 0u;
  // shared writes of this stage's last use (generic proxy) before the
  // bulk copy's (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  const uint32_t dst = smem_addr(stage + (a & 15) + (lo - a));
  for (uint32_t off = 0; off < bytes; off += kCopyPiece)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(dst + off),
        "l"(lo + off), "r"(min(kCopyPiece, bytes - off)),
        "r"(smem_addr(bar))
        : "memory");
}

// Every thread: the words of tile `g` that issue_tile leaves.
__device__ __forceinline__ void copy_edges(uint32_t* w,
                                           const uint32_t* __restrict__ g,
                                           int cap) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  const uintptr_t lo = (a + 15) & ~(uintptr_t)15;
  const uintptr_t hi = (a + sizeof(uint32_t) * (size_t)cap) & ~(uintptr_t)15;
  const int head = hi > lo ? (int)((lo - a) / 4) : cap;
  const int body = hi > lo ? (int)((hi - lo) / 4) : 0;
  for (int i = threadIdx.x; i < cap - body; i += blockDim.x) {
    const int p = i < head ? i : i + body;
    w[p] = g[p];
  }
}

template <int LC, bool kStaged>
__global__ void __launch_bounds__(kFusedThreads, 2)
fused_kernel(const uint32_t* __restrict__ tiles, int T, int cap, int bd,
             const int* __restrict__ q_ids, const float* __restrict__ q_vals,
             const float* __restrict__ q_norms, int Qm, int L, int kp,
             float* __restrict__ vals_out, int* __restrict__ ids_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FusedLayout f = fused_layout(cap, bd, Qm, L, kStaged);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // the stage's
  QueryTile qt = QueryTile::at(smem + f.query, query_tile_smem(Qm));
  float* s_corr = reinterpret_cast<float*>(smem + f.corr);       // [LC, bd]
  float* s_norm = reinterpret_cast<float*>(smem + f.norm);       // [bd]
  int* s_docid = reinterpret_cast<int*>(smem + f.docid);         // [bd]
  int* s_start = reinterpret_cast<int*>(smem + f.start);         // [bd + 1]
  int* s_count = reinterpret_cast<int*>(smem + f.count);         // [warps]
  int* s_last = s_count + kFusedWarps;                           // [warps]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = n_query_tiles(Qm);
  if (kStaged && tid == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (kStaged && tid == 0 && (int)blockIdx.x < T)
    issue_tile(bar, smem + f.tile, tiles + (size_t)blockIdx.x * cap, cap);
  // one query tile and one column pass: the table and the run sums are
  // built once for every doc tile
  const bool once = nt == 1 && L <= LC;
  if (nt == 1) qt.load(q_ids, Qm, 0, kKeyMask, LC, LC);
  if (once) qt.sum_runs<LC>(QueryCols{q_vals, L, 0, L});

  uint32_t phase = 0;                      // the stage's next phase
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    const uint32_t* g = tiles + (size_t)tile * cap;
    const uint32_t* wp = g;
    if constexpr (kStaged) {
      uint32_t* w = reinterpret_cast<uint32_t*>(
          smem + f.tile + (reinterpret_cast<uintptr_t>(g) & 15));
      copy_edges(w, g, cap);
      mbar_wait(bar, phase);
      phase ^= 1u;
      wp = w;
    }
    __syncthreads();                       // the tile's words are in

    // -- decode: each warp scans its own range of the tile, 128 words a
    // step (words p0 + 32 i + lane, i < 4): its headers and its last word
    // that is not a pad, then, after one barrier and a prefix over the
    // warps, where each of its rows starts
    const int per = ((cap + kFusedWarps - 1) / kFusedWarps + 127) & ~127;
    const int a0 = min(cap, warp * per), a1 = min(cap, a0 + per);
    int count = 0, last = -1;
    for (int p0 = a0; p0 < a1; p0 += 128) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + 32 * i + lane;
        w[i] = p < a1 ? wp[p] : kPadWord;
      }
      // a step of pads only (the tile's tail) costs one vote
      if (__all_sync(kFull, (w[0] & w[1] & w[2] & w[3]) == kPadWord)) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        count += is_header(w[i]);
        if (w[i] != kPadWord) last = p0 + 32 * i + lane;
      }
    }
    count = __reduce_add_sync(kFull, count);
    last = __reduce_max_sync(kFull, last);
    if (lane == 0) {
      s_count[warp] = count;
      s_last[warp] = last;
    }
    __syncthreads();
    int row = 0, n_hdr = 0, end = 0;
    for (int i = 0; i < kFusedWarps; ++i) {
      row += i < warp ? s_count[i] : 0;
      n_hdr += s_count[i];
      end = max(end, s_last[i] + 1);
    }
    const unsigned below = (1u << lane) - 1u;
    for (int p0 = a0; p0 < min(a1, end); p0 += 128) {   // no header past end
      uint32_t w[4];
      unsigned b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + 32 * i + lane;
        w[i] = p < a1 ? wp[p] : kPadWord;
        b[i] = __ballot_sync(kFull, is_header(w[i]));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (is_header(w[i])) {
          const int r = row + __popc(b[i] & below);
          if (r <= bd) s_start[r] = p0 + 32 * i + lane;
        }
        row += __popc(b[i]);
      }
    }
    const int n_rows = min(n_hdr, bd);     // rows past bd are dropped
    for (int r = n_rows + tid; r < bd; r += kFusedThreads) {
      s_norm[r] = 0.f;
      s_docid[r] = -1;
    }
    __syncthreads();

    // -- match: a half warp a row (two rows a warp), column pass by pass
    const int half = lane >> 4, hl = lane & 15;
    for (int c0 = 0; c0 < L; c0 += LC) {
      const int nc = min(LC, L - c0);
      for (int t = 0; t < nt; ++t) {
        if (nt > 1) qt.load(q_ids, Qm, t, kKeyMask, LC, LC);
        const QueryCols q{q_vals + (size_t)t * kMaxTileItems * L, L, c0, nc};
        if (!once) qt.sum_runs<LC>(q);
        const bool first = c0 == 0 && t == 0;  // the sweep that takes norms
        for (int r2 = 2 * warp; r2 < n_rows; r2 += 2 * kFusedWarps) {
          const int r = r2 + half;
          const bool live = r < n_rows;
          float acc[LC];
#pragma unroll
          for (int c = 0; c < LC; ++c) acc[c] = 0.f;
          float sq[1] = {0.f};
          const int e = !live ? 0 : r + 1 < n_hdr ? s_start[r + 1] : end;
          for (int p = live ? s_start[r] + 1 + hl : 0; p < e;
               p += 16 * kWordsPerLane) {
            uint32_t w[kWordsPerLane];
            int id[kWordsPerLane];
            float v[kWordsPerLane];
            bool ok[kWordsPerLane];
#pragma unroll
            for (int j = 0; j < kWordsPerLane; ++j) {
              w[j] = p + 16 * j < e ? wp[p + 16 * j] : kPadWord;
              ok[j] = is_pair(w[j]);
              id[j] = (int)((w[j] >> kValBits) & kKeyMask);
              v[j] = (float)(w[j] & kValMask);
              if (first && ok[j]) sq[0] += v[j] * v[j];
            }
            match_words<LC, kWordsPerLane>(qt, q, id, v, ok, acc);
          }
          const float sum = warp_sum_cols<LC, 16>(acc, lane);
          if (live && write_lane<LC, 16>(lane)) {
            float* o = s_corr + col_of<LC, 16>(lane) * bd + r;
            *o = t == 0 ? sum : *o + sum;
          }
          if (first) {
            const float norm2 = warp_sum_cols<1, 16>(sq, lane);
            if (live && hl == 0) {
              s_norm[r] = sqrtf(norm2);
              s_docid[r] = (int)(wp[s_start[r]] & kMaxDocId);
            }
          }
        }
      }
      __syncthreads();
      // the tile is not read after its last column pass: the next tile's
      // copy overlaps this epilogue
      if (kStaged && c0 + LC >= L && tid == 0 &&
          tile + (int)gridDim.x < T)
        issue_tile(bar, smem + f.tile, g + (size_t)gridDim.x * cap, cap);

      // -- epilogue: cosine, then each column's best kp rows -------------
      for (int l = warp; l < nc; l += kFusedWarps) {
        const float qn = q_norms[c0 + l];
        float* col = s_corr + l * bd;
        for (int r = lane; r < bd; r += 32) {
          const float denom = s_norm[r] * qn;
          float cs = denom > 0.f ? col[r] / fmaxf(denom, 1e-12f) : -INFINITY;
          if (s_docid[r] < 0) cs = -INFINITY;
          col[r] = cs;
        }
        __syncwarp();
        // kp rounds; each takes the warp's best row not yet taken by two
        // redux.sync, the largest key and then the lowest row holding it
        // (ties keep the lower row). Lane s % 32 keeps round s's row, and
        // the rows are written 32 rounds at a time.
        int won = 0;
        auto take = [&](int s, int best_r) {
          if ((s & 31) == lane) won = best_r;
          if ((s & 31) == 31 || s == kp - 1) {   // rounds s & ~31 .. s
            const int s0 = s & ~31;
            if (s0 + lane <= s) {
              const size_t o = ((size_t)tile * L + c0 + l) * kp + s0 + lane;
              vals_out[o] = col[won];
              const int d = s_docid[won];
              ids_out[o] = d >= 0 ? d : -1;
            }
          }
        };
        if (bd <= 128) {
          // a lane's (at most) four rows, sorted by key, then row, in
          // registers: a round is two redux.sync and a shift in the lane
          // whose head was taken
          int key[4], row[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = lane + 32 * j;
            key[j] = r < bd ? rank_key(col[r]) : INT_MIN;
            row[j] = r < bd ? r : INT_MAX;
          }
          auto order = [&](int a, int b) {  // a before b: larger key first
            if (key[b] > key[a] || (key[b] == key[a] && row[b] < row[a])) {
              const int k = key[a], r = row[a];
              key[a] = key[b];
              row[a] = row[b];
              key[b] = k;
              row[b] = r;
            }
          };
          order(0, 1);
          order(2, 3);
          order(0, 2);
          order(1, 3);
          order(1, 2);
          for (int s = 0; s < kp; ++s) {
            const int best_key = __reduce_max_sync(kFull, key[0]);
            const int best_r =
                __reduce_min_sync(kFull, key[0] == best_key ? row[0] : INT_MAX);
            if (row[0] == best_r) {
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                key[j] = key[j + 1];
                row[j] = row[j + 1];
              }
              key[3] = INT_MIN;
              row[3] = INT_MAX;
            }
            take(s, best_r);
          }
        } else {
          // more rows a lane: the lane that owned the taken row looks again
          unsigned taken = 0u;             // bit j: row lane + 32 j chosen
          int my_key, my_r;
          auto own_best = [&]() {
            my_key = INT_MIN;
            my_r = INT_MAX;
#pragma unroll 4
            for (int j = 0, r = lane; r < bd; ++j, r += 32) {
              const int key = (taken >> j) & 1u ? INT_MIN : rank_key(col[r]);
              if (key > my_key) {
                my_key = key;
                my_r = r;
              }
            }
          };
          own_best();
          for (int s = 0; s < kp; ++s) {
            const int best_key = __reduce_max_sync(kFull, my_key);
            const int best_r =
                __reduce_min_sync(kFull, my_key == best_key ? my_r : INT_MAX);
            if ((best_r & 31) == lane) {
              taken |= 1u << (best_r >> 5);
              own_best();
            }
            take(s, best_r);
          }
        }
      }
      __syncthreads();                     // s_corr, and the stage, are free
    }
  }
}

template <int LC, bool kStaged>
int launch_fused(int device, const uint32_t* tiles, const int* q_ids,
                 const float* q_vals, const float* q_norms, float* vals_out,
                 int* ids_out, int T, int cap, int bd, int Qm, int L, int kp,
                 size_t smem, cudaStream_t stream) {
  const int resident = resident_blocks(device, fused_kernel<LC, kStaged>,
                                       kFusedThreads, smem);
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  fused_kernel<LC, kStaged><<<std::min(resident, T), kFusedThreads, smem,
                              stream>>>(tiles, T, cap, bd, q_ids, q_vals,
                                        q_norms, Qm, L, kp, vals_out,
                                        ids_out);
  return (int)cudaGetLastError();
}

}  // namespace rsm

// Shared memory the launch needs, in bytes, with `stages` tile stages
// (1, or 0: the tile is read from device memory).
extern "C" long long fused_match_topk_smem(int cap, int bd, int Qm, int L,
                                           int stages) {
  return (long long)rsm::fused_layout(cap, bd, Qm, L, stages > 0).bytes;
}

// Tile stages for a launch, from the card's shared memory a block
// (`optin`): one where it fits, else 0 (the tile is read from device
// memory); -1 if not even that fits.
extern "C" int fused_match_topk_stages(int cap, int bd, int Qm, int L,
                                       long long optin) {
  for (int s = 1; s >= 0; --s)
    if (fused_match_topk_smem(cap, bd, Qm, L, s) <= optin) return s;
  return -1;
}

extern "C" int fused_match_topk_launch(int device, const uint32_t* tiles,
                                       const int* q_ids, const float* q_vals,
                                       const float* q_norms, float* vals_out,
                                       int* ids_out, int T, int cap, int bd,
                                       int Qm, int L, int kp,
                                       cudaStream_t stream) {
  if (T <= 0 || L <= 0) return (int)cudaSuccess;
  if (bd < 1 || bd > rsm::kMaxTileRows || kp < 1 || kp > bd || cap < 1)
    return (int)cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t e = cudaSetDevice(device);  // this runtime's own current card
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  const int stages = fused_match_topk_stages(cap, bd, Qm, L, optin);
  if (stages < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)fused_match_topk_smem(cap, bd, Qm, L, stages);
  return rsm::with_pass_cols(L, [&](auto lc) {
    constexpr int LC = decltype(lc)::value;
    return stages ? rsm::launch_fused<LC, true>(device, tiles, q_ids, q_vals,
                                                q_norms, vals_out, ids_out, T,
                                                cap, bd, Qm, L, kp, smem,
                                                stream)
                  : rsm::launch_fused<LC, false>(device, tiles, q_ids,
                                                 q_vals, q_norms, vals_out,
                                                 ids_out, T, cap, bd, Qm, L,
                                                 kp, smem, stream);
  });
}
