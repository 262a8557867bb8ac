// Packed-word sparse match: the port's backend "gpu_packed" (B2).
//
// Replaces src/repro/kernels/sparse_match_packed.py::_kernel (backend
// "pallas_packed"), which unpacks Fig. 8 words (wordID << 12 | count, pad
// 0xFFFFFFFF) and multiplies the match matrix eq[d*k, q] on the MXU. Here
// each doc word looks its id up in the query tile's hashed table
// (match.cuh) and adds count x its run's summed value row.
//
// Bound on the H100: bytes. At 2^20 docs x nnz_pad 128 the kernel reads
// 2^27 x 4 B = 0.54 GB of words once: 0.170 ms at 3.35 TB/s with the
// query stream and the [D, L] output. A multiply-add per word that hits
// is far below the card's rate.
//
// The first design took the same 1.60 ms as the ELL kernel on half its
// bytes: each word paid a 12-step binary search in shared memory (H100
// 80GB HBM3, 700 W; the times below are benchmarks/port_match_variants.py
// on that card, L = 8, Qm = 4096, at the main request of ~50 ids a query
// unless they name longer queries). Here:
//  - the lookup is the table of match.cuh: a miss (~78% of the words that
//    are not pads at L = 8) costs one or two shared loads, a hit one more
//    load and one row of its run's sums: 0.60-0.63 ms, of which a
//    constant miss leaves 0.51-0.54 (the loop, its loads and the column
//    reduction); summing the runs ahead saves 0.7 ms against walking each
//    hit's run (1.30-1.31);
//  - a word a lane, a row of 128 in four coalesced loads, and the warp's
//    next word is loaded before this one's lookup. The loads stream past
//    L1 (__ldcs) so that the query values stay there. Four words a lane
//    by one 16-byte load was no faster (0.60-0.63 ms against 0.61), nor
//    was a ring of four or eight rows a warp in shared memory (cp.async;
//    tried, not kept);
//  - blocks are persistent (as many as the card holds at once, from the
//    occupancy of this kernel and its shared memory) and each warp
//    strides over rows, so a block builds a query tile's table and run
//    sums once, not once every 256 rows. Streams of more than one tile
//    (Qm > 8192) rebuild them per tile, in tile order;
//  - registers are capped for four blocks an SM (64 a thread; uncapped,
//    74 and three blocks: 0.68-0.70 ms), and a block's query tile takes
//    the shared memory they leave (smem_share: 56 KB). Longer queries
//    hold more real items than 8-column sums fit there (over ~1300 at
//    L = 8); the passes then narrow to 4 columns, two sweeps of the docs
//    (1.21-1.25 ms at 192 ids a query against 1.79-1.81 walking), and
//    past ~2400 real items hits walk their runs (2.84-2.86 ms at 512 ids
//    a query, against 3.56 for the first design; passes of 1 column took
//    6.1);
//  - a row's LC column sums leave the warp by a transposed shuffle tree
//    (9 shuffles for 8 columns, not 40), and 8 lanes store them.
// A lane sums its slots in order and the lanes by that fixed tree:
// integral counts are exact in any order, so they agree bit for bit with
// the plain version; float query values agree within the stated
// tolerance (a sum of at most K products in another order).
#include "match.cuh"

namespace rsm {

constexpr uint32_t kPackedMaxKey = (1u << 20) - 1;  // w >> 12 of a word
constexpr int kMinPassCols = 4;            // narrower passes: hits walk
constexpr int kBlocksPerSm = 4;            // registers capped for four

// The word in slot c * 32 + lane of row r, or a pad past the row or the
// matrix.
__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ docs,
                                              int D, int K, int r, int c,
                                              int lane) {
  const int k = c * 32 + lane;
  return r < D && k < K ? __ldcs(docs + (size_t)r * K + k) : kPadWord;
}

template <int LC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
packed_kernel(const uint32_t* __restrict__ docs, int D, int K,
              const int* __restrict__ q_ids, const float* __restrict__ q_vals,
              int Qm, int L, size_t tile_bytes, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  QueryTile qt = QueryTile::at(smem, tile_bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = blockIdx.x * kWarps + warp;   // this warp's first row
  const int stride = gridDim.x * kWarps;
  const int chunks = max(1, (K + 31) / 32);       // loads a row
  const int nt = n_query_tiles(Qm);
  for (int t = 0; t < nt; ++t) {
    qt.load(q_ids, Qm, t, kPackedMaxKey, LC, min(LC, kMinPassCols));
    const int w = qt.cols ? qt.cols : LC;         // this tile's pass width
    for (int c0 = 0; c0 < L; c0 += w) {
      const QueryCols q{q_vals + (size_t)t * kMaxTileItems * L, L, c0,
                        min(w, L - c0)};
      qt.sum_runs<LC>(q);
      float acc[LC];
#pragma unroll
      for (int c = 0; c < LC; ++c) acc[c] = 0.f;
      int r = first, c = 0;
      uint32_t word = load_word(docs, D, K, r, c, lane);
      while (r < D) {
        int nr = r, nc = c + 1;            // the warp's next load
        if (nc == chunks) {
          nr = r + stride;
          nc = 0;
        }
        const uint32_t next = load_word(docs, D, K, nr, nc, lane);
        const int id[1] = {(int)(word >> kValBits)};
        const float v[1] = {(float)(word & kValMask)};
        const bool ok[1] = {word != kPadWord};
        match_words<LC, 1>(qt, q, id, v, ok, acc);
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
        word = next;
      }
    }
  }
}

// Dynamic shared memory of a launch: its query tile.
template <int LC>
size_t packed_smem(int device, int Qm) {
  return smem_share(device, packed_kernel<LC>, kThreads, query_tile_smem(Qm));
}

template <int LC>
int launch_packed(int device, const uint32_t* docs, const int* q_ids,
                  const float* q_vals, float* out, int D, int K, int Qm,
                  int L, cudaStream_t stream) {
  const size_t smem = packed_smem<LC>(device, Qm);
  const int resident =
      smem ? resident_blocks(device, packed_kernel<LC>, kThreads, smem) : 0;
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const int blocks = std::min(resident, (D + kWarps - 1) / kWarps);
  packed_kernel<LC><<<blocks, kThreads, smem, stream>>>(
      docs, D, K, q_ids, q_vals, Qm, L, smem, out);
  return (int)cudaGetLastError();
}

}  // namespace rsm

// The dynamic shared memory a launch for Qm query items and L columns
// takes on card `device` (0 on an error).
extern "C" int sparse_match_packed_smem(int device, int Qm, int L) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  return (int)rsm::with_pass_cols(L, [&](auto lc) {
    return rsm::packed_smem<decltype(lc)::value>(device, Qm);
  });
}

extern "C" int sparse_match_packed_launch(int device,
                                          const uint32_t* docs_packed,
                                          const int* q_ids,
                                          const float* q_vals, float* out,
                                          int D, int K, int Qm, int L,
                                          cudaStream_t stream) {
  if (D <= 0 || L <= 0) return (int)cudaSuccess;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return rsm::with_pass_cols(L, [&](auto lc) {
    return rsm::launch_packed<decltype(lc)::value>(
        device, docs_packed, q_ids, q_vals, out, D, K, Qm, L, stream);
  });
}
