// Device code shared by the three search kernels (sparse_match.cu,
// sparse_match_packed.cu, fused.cu): the merged query stream held in
// shared memory tile by tile, the lookup of the run of query items that
// carry one word id, and the warp-per-document-row match loop.
//
// The merged stream (kernels/ops.py) is the real ids in ascending order
// followed by query pads (-2). Under the key "pads sort last" it is
// sorted, so each document word finds its run by binary search in
// O(log Qm). A stream in any other order is still scored correctly: a
// block that finds its tile unsorted scans the whole tile for every word.
//
// Numerics: sums are taken in a fixed order (run items in stream order,
// then one warp's lanes by a shuffle tree), never with atomics, so a
// launch is deterministic. The build uses IEEE division and square root
// and no FMA contraction (no --use_fast_math, -fmad=false).
#pragma once

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "error.cuh"

namespace rsm {

constexpr int kThreads = 256;              // 8 warps a block
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

// Query pads (any negative id) sort after every real id.
__device__ __forceinline__ int qkey(int id) { return id < 0 ? INT_MAX : id; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Query tile count: at least one, so an empty stream still scores (every
// document then gets 0 * its values, as a tile of pads gives).
__host__ __device__ __forceinline__ int n_query_tiles(int Qm) {
  return Qm <= 0 ? 1 : (Qm + kMaxTileItems - 1) / kMaxTileItems;
}

// Load the ids of query tile `t` into shared memory; returns its item
// count and whether it is in key order. Every thread of the block must
// call it: it ends with a barrier.
__device__ __forceinline__ int load_query_tile(const int* __restrict__ q_ids,
                                               int Qm, int t, int* s_ids,
                                               bool* sorted) {
  const int t0 = t * kMaxTileItems;
  const int n = max(0, min(kMaxTileItems, Qm - t0));
  __syncthreads();                         // the previous tile is done
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_ids[i] = q_ids[t0 + i];
  __syncthreads();
  int ok = 1;
  for (int i = threadIdx.x; i + 1 < n; i += blockDim.x)
    ok &= qkey(s_ids[i]) <= qkey(s_ids[i + 1]);
  *sorted = __syncthreads_and(ok) != 0;
  return n;
}

// m[c] = sum of qv[p * L + c0 + c] over the tile items p whose id equals
// `id` (id >= 0), in stream order; qv points at the tile's first row.
template <int LC>
__device__ __forceinline__ void run_sum(const int* s_ids, int n, bool sorted,
                                        int id, const float* __restrict__ qv,
                                        int L, int c0, int nc,
                                        float (&m)[LC]) {
#pragma unroll
  for (int c = 0; c < LC; ++c) m[c] = 0.f;
  int p = 0;
  if (sorted) {                            // lower bound of id's run
    int hi = n;
    while (p < hi) {
      const int mid = (p + hi) >> 1;
      if (qkey(s_ids[mid]) < id) p = mid + 1; else hi = mid;
    }
  }
  for (; p < n; ++p) {
    const int q = s_ids[p];
    if (q != id) {
      if (sorted && qkey(q) != id) break;  // past the run
      continue;
    }
    const float* row = qv + (size_t)p * L + c0;
#pragma unroll
    for (int c = 0; c < LC; ++c)
      if (c < nc) m[c] += __ldg(row + c);
  }
}

// Doc readers: slot i of the [D, K] doc matrix -> (word id, value), or
// false for a pad slot.
struct EllDocs {                           // ids int32 (pad < 0), vals f32
  const int* ids;
  const float* vals;
  __device__ __forceinline__ bool get(size_t i, int& id, float& v) const {
    id = ids[i];
    if (id < 0) return false;
    v = vals[i];
    return true;
  }
};

struct PackedDocs {                        // wordID << 12 | count, pad ~0
  const uint32_t* words;
  __device__ __forceinline__ bool get(size_t i, int& id, float& v) const {
    const uint32_t w = words[i];
    if (w == kPadWord) return false;
    id = (int)(w >> kValBits);
    v = (float)(w & kValMask);
    return true;
  }
};

// out[d, c] = sum_k val[d, k] * (sum of q_vals[q, c] over items q with
// q_id == id[d, k]), for rows [r0, r1) of this block: one warp per row,
// lanes over the row's K slots (coalesced), query tiles in a loop.
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

constexpr int kRowsPerBlock = 256;         // 32 rows a warp

// Host side: pick the column pass width from L and launch on `stream`
// of card `device` (this library's CUDA runtime keeps its own current
// device, so it is set from the caller's tensors on every launch).
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
  if (L == 1)
    match_kernel<Docs, 1><<<blocks, kThreads, smem, stream>>>(
        docs, D, K, q_ids, q_vals, Qm, L, out, kRowsPerBlock);
  else if (L == 2)
    match_kernel<Docs, 2><<<blocks, kThreads, smem, stream>>>(
        docs, D, K, q_ids, q_vals, Qm, L, out, kRowsPerBlock);
  else if (L <= 4)
    match_kernel<Docs, 4><<<blocks, kThreads, smem, stream>>>(
        docs, D, K, q_ids, q_vals, Qm, L, out, kRowsPerBlock);
  else
    match_kernel<Docs, kMaxCols><<<blocks, kThreads, smem, stream>>>(
        docs, D, K, q_ids, q_vals, Qm, L, out, kRowsPerBlock);
  return (int)cudaGetLastError();
}

}  // namespace rsm
