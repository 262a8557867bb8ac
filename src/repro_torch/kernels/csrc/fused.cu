// Fused decode + match + per-tile top-k: the port's backend "gpu_fused".
//
// Replaces src/repro/kernels/fused.py::_fused_kernel (backend
// "pallas_fused"). Input is the Fig. 8 stream cut into [T, cap] uint32 doc
// tiles (cap = block_docs * (1 + nnz_pad), pad 0xFFFFFFFF): one block a
// tile. The block
//   1. finds each document's header by a block-wide scan of the header
//      bits (ballot + warp counts), so row r spans the words from its
//      header to the next one;
//   2. per row (one warp each): the L2 norm of the counts (sqrtf, IEEE)
//      and the doc id from the header;
//   3. matches every pair word against the merged query stream, tile by
//      tile, by the run lookup of match.cuh, into corr [bd, L] in shared
//      memory;
//   4. takes the cosine (-inf where the denominator is <= 0 or the row is
//      a pad) and, per column, the best kp rows by repeated warp argmax,
//      ranking NaN as +inf and breaking ties to the lower row, as the
//      Pallas epilogue's lax.top_k does.
// Only [T, L, kp] candidates leave the card's shared memory.
//
// Bound on the H100: bytes. At 2^20 docs x nnz_pad 128 the tiles are
// 8192 x 16512 words = 0.54 GB read once, about 0.16 ms at 3.35 TB/s;
// queries and candidates are a few MB. A tile's words are read three
// times (scan, norms, match) but the second and third reads hit L1/L2.
#include <cmath>

#include "match.cuh"

namespace rsm {

constexpr int kMaxTileRows = 1024;         // 32 lanes x 32 bits of "taken"

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

template <int LC>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const uint32_t* __restrict__ tiles, int cap, int bd,
             const int* __restrict__ q_ids, const float* __restrict__ q_vals,
             const float* __restrict__ q_norms, int Qm, int L, int kp,
             int tile_items, float* __restrict__ vals_out,
             int* __restrict__ ids_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_ids = reinterpret_cast<int*>(smem);                     // [items]
  float* s_corr = reinterpret_cast<float*>(s_ids + tile_items);  // [bd, L]
  float* s_norm = s_corr + (size_t)bd * L;                       // [bd]
  int* s_docid = reinterpret_cast<int*>(s_norm + bd);            // [bd]
  int* s_start = s_docid + bd;                                   // [bd + 1]
  int* s_count = s_start + bd + 1;                               // [kWarps]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t* words = tiles + (size_t)blockIdx.x * cap;

  // -- 1. decode: s_start[r] = position of the r-th header word ---------
  int base = 0;
  for (int c0 = 0; c0 < cap; c0 += kThreads) {
    const int p = c0 + threadIdx.x;
    const uint32_t w = p < cap ? words[p] : kPadWord;
    const bool hdr = (w & kHeaderBit) && w != kPadWord;
    const unsigned b = __ballot_sync(kFull, hdr);
    if (lane == 0) s_count[warp] = __popc(b);
    __syncthreads();
    int off = base, total = base;
    for (int i = 0; i < kWarps; ++i) {
      const int c = s_count[i];
      if (i < warp) off += c;
      total += c;
    }
    if (hdr) {
      const int r = off + __popc(b & ((1u << lane) - 1u));
      if (r <= bd) s_start[r] = p;
    }
    __syncthreads();                       // s_count is reused
    base = total;
  }
  const int n_hdr = base;
  const int n_rows = min(n_hdr, bd);       // rows past bd are dropped
  auto row_end = [&](int r) { return r + 1 < n_hdr ? s_start[r + 1] : cap; };

  // -- 2. prologue: norms, doc ids, zeroed correlation ----------------
  for (int i = threadIdx.x; i < bd * L; i += kThreads) s_corr[i] = 0.f;
  for (int r = warp; r < bd; r += kWarps) {
    float sq = 0.f;
    if (r < n_rows) {
      const int e = row_end(r);
      for (int p = s_start[r] + 1 + lane; p < e; p += 32) {
        const uint32_t w = words[p];
        if (is_pair(w)) {
          const float v = (float)(w & kValMask);
          sq += v * v;
        }
      }
    }
    sq = warp_sum(sq);
    if (lane == 0) {
      s_norm[r] = sqrtf(sq);
      s_docid[r] = r < n_rows ? (int)(words[s_start[r]] & kMaxDocId) : -1;
    }
  }

  // -- 3. match, query tile by tile (each tile load starts with a barrier)
  const int nt = n_query_tiles(Qm);
  for (int t = 0; t < nt; ++t) {
    bool sorted;
    const int n = load_query_tile(q_ids, Qm, t, s_ids, &sorted);
    const float* qv = q_vals + (size_t)t * kMaxTileItems * L;
    for (int c0 = 0; c0 < L; c0 += LC) {
      const int nc = min(LC, L - c0);
      for (int r = warp; r < n_rows; r += kWarps) {
        float acc[LC];
#pragma unroll
        for (int c = 0; c < LC; ++c) acc[c] = 0.f;
        const int e = row_end(r);
        for (int p = s_start[r] + 1 + lane; p < e; p += 32) {
          const uint32_t w = words[p];
          if (!is_pair(w)) continue;
          const int id = (int)((w >> kValBits) & kKeyMask);
          const float v = (float)(w & kValMask);
          float m[LC];
          run_sum<LC>(s_ids, n, sorted, id, qv, L, c0, nc, m);
#pragma unroll
          for (int c = 0; c < LC; ++c) acc[c] += v * m[c];
        }
#pragma unroll
        for (int c = 0; c < LC; ++c) acc[c] = warp_sum(acc[c]);
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < LC; ++c)
            if (c < nc) s_corr[r * L + c0 + c] += acc[c];
        }
      }
    }
  }
  __syncthreads();

  // -- 4. epilogue: cosine, then each column's best kp rows -------------
  for (int l = warp; l < L; l += kWarps) {
    const float qn = q_norms[l];
    for (int r = lane; r < bd; r += 32) {
      const float denom = s_norm[r] * qn;
      float cs = denom > 0.f ? s_corr[r * L + l] / fmaxf(denom, 1e-12f)
                             : -INFINITY;
      if (s_docid[r] < 0) cs = -INFINITY;
      s_corr[r * L + l] = cs;
    }
    __syncwarp();
    unsigned taken = 0u;                   // bit j: row lane + 32 j chosen
    for (int s = 0; s < kp; ++s) {
      int best_key = INT_MIN, best_r = INT_MAX;
      for (int j = 0, r = lane; r < bd; ++j, r += 32) {
        if ((taken >> j) & 1u) continue;
        const int key = rank_key(s_corr[r * L + l]);
        if (key > best_key) {              // rows ascend: ties keep the lower
          best_key = key;
          best_r = r;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const int ok = __shfl_xor_sync(kFull, best_key, o);
        const int orow = __shfl_xor_sync(kFull, best_r, o);
        if (ok > best_key || (ok == best_key && orow < best_r)) {
          best_key = ok;
          best_r = orow;
        }
      }
      if ((best_r & 31) == lane) taken |= 1u << (best_r >> 5);
      if (lane == 0) {
        const size_t o = ((size_t)blockIdx.x * L + l) * kp + s;
        vals_out[o] = s_corr[best_r * L + l];
        const int d = s_docid[best_r];
        ids_out[o] = d >= 0 ? d : -1;
      }
    }
  }
}

template <int LC>
int launch_fused(const uint32_t* tiles, const int* q_ids, const float* q_vals,
                 const float* q_norms, float* vals_out, int* ids_out, int T,
                 int cap, int bd, int Qm, int L, int kp, int tile_items,
                 size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_kernel<LC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_kernel<LC><<<T, kThreads, smem, stream>>>(
      tiles, cap, bd, q_ids, q_vals, q_norms, Qm, L, kp, tile_items,
      vals_out, ids_out);
  return (int)cudaGetLastError();
}

}  // namespace rsm

// Shared memory the launch needs, in bytes (the wrapper checks it).
extern "C" long long fused_match_topk_smem(int bd, int Qm, int L) {
  const long long tile_items =
      std::max(1, std::min(Qm, rsm::kMaxTileItems));
  return (long long)sizeof(int) *
         (tile_items + (long long)bd * L + 3LL * bd + 1 + rsm::kWarps);
}

extern "C" int fused_match_topk_launch(int device, const uint32_t* tiles,
                                       const int* q_ids, const float* q_vals,
                                       const float* q_norms, float* vals_out,
                                       int* ids_out, int T, int cap, int bd,
                                       int Qm, int L, int kp,
                                       cudaStream_t stream) {
  if (T <= 0 || L <= 0) return (int)cudaSuccess;
  if (bd < 1 || bd > rsm::kMaxTileRows || kp < 1 || kp > bd)
    return (int)cudaErrorInvalidValue;
  const int tile_items = std::max(1, std::min(Qm, rsm::kMaxTileItems));
  const size_t smem = (size_t)fused_match_topk_smem(bd, Qm, L);
  int optin = 0;
  cudaError_t e = cudaSetDevice(device);  // this runtime's own current card
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (L == 1)
    return rsm::launch_fused<1>(tiles, q_ids, q_vals, q_norms, vals_out,
                                ids_out, T, cap, bd, Qm, L, kp, tile_items,
                                smem, stream);
  if (L == 2)
    return rsm::launch_fused<2>(tiles, q_ids, q_vals, q_norms, vals_out,
                                ids_out, T, cap, bd, Qm, L, kp, tile_items,
                                smem, stream);
  if (L <= 4)
    return rsm::launch_fused<4>(tiles, q_ids, q_vals, q_norms, vals_out,
                                ids_out, T, cap, bd, Qm, L, kp, tile_items,
                                smem, stream);
  return rsm::launch_fused<rsm::kMaxCols>(tiles, q_ids, q_vals, q_norms,
                                          vals_out, ids_out, T, cap, bd, Qm,
                                          L, kp, tile_items, smem, stream);
}
