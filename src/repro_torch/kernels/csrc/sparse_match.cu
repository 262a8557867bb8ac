// ELL sparse match: the port's backend "gpu" (B1).
//
// Replaces src/repro/kernels/sparse_match.py::_kernel (backend "pallas"),
// which builds a match matrix eq[d*k, q] = (doc_id == q_id) and runs
// eq @ q_vals on the MXU. Here each document slot looks its id up in the
// query tile's hashed table (match.cuh) and adds value x its run's summed
// value row, in the loop B2 runs (table_kernel), over ELL's two arrays.
//
// Bound on the H100: bytes. At 2^20 docs x nnz_pad 128 every id must be
// read (2^27 x 4 B = 0.54 GB) and the value of each slot that holds a
// word (~0.25 GB for the paper's ~60 words a doc; 0.54 GB if full):
// 0.235 ms at 3.35 TB/s with the query stream and the [D, L] output. The
// arithmetic (one multiply-add per matched slot and column) is far below
// the card's rate.
//
// What is ELL's own:
//  - ids are any int32 (pad < 0), so the table holds every non-negative
//    id (kMaxKey 2^31 - 1), not only the 20 or 19 bits of B2's and B3's
//    words;
//  - a slot's value is a second load, issued only for a slot whose id is
//    not a pad (a pad slot's value is never read) and before the slot's
//    lookup, so that it arrives while the lookup's shared loads run;
//  - values may be any float, so a miss whose value is not finite adds
//    NaN (value x 0), as the plain version does.
// Times (H100 80GB HBM3, 700 W; benchmarks/port_match_variants.py at the
// main shape, L = 8, Qm = 4096): 0.69-0.74 ms, against 1.59-1.67 for the
// first design (one warp a row, 256 rows a block, the binary search). A
// constant miss leaves 0.66-0.68: the loop and its two loads, not the
// lookup, are what is left. Taken back, each choice is slower or no
// faster: registers not capped for four blocks an SM 0.83, the value
// read only on a hit 0.73, two slots in flight a lane 0.72-0.74 (it
// spills at 64 registers). At 192 ids a query the uncapped kernel's
// larger query tile holds 8-column sums, one pass, and takes 0.88 ms
// against 1.43 (two passes of 4).
#include "match.cuh"

namespace rsm {

// B1's doc reader for table_kernel: an id and, for a word, its value.
struct EllDocs {
  using Slot = int;
  static constexpr uint32_t kMaxKey = kMaxDocId;   // every id >= 0
  static constexpr bool kFloatVals = true;
  static constexpr int kBlocksPerSm = 4;           // 64 registers a thread
  const int* __restrict__ ids;                     // [D, K], pad < 0
  const float* __restrict__ vals;                  // [D, K]

  __device__ __forceinline__ Slot load(int r, int k, int D, int K) const {
    return r < D && k < K ? __ldcs(ids + (size_t)r * K + k) : -1;
  }
  __device__ __forceinline__ void word(Slot s, int r, int k, int K, int& id,
                                       float& v, bool& ok) const {
    id = s;
    ok = s >= 0;
    v = ok ? __ldcs(vals + (size_t)r * K + k) : 0.f;   // before the lookup
  }
};

}  // namespace rsm

// The dynamic shared memory a launch for Qm query items and L columns
// takes on card `device` (0 on an error).
extern "C" int sparse_match_smem(int device, int Qm, int L) {
  return rsm::table_smem_bytes<rsm::EllDocs>(device, Qm, L);
}

extern "C" int sparse_match_launch(int device, const int* doc_ids,
                                   const float* doc_vals, const int* q_ids,
                                   const float* q_vals, float* out, int D,
                                   int K, int Qm, int L, cudaStream_t stream) {
  return rsm::launch_table(device, rsm::EllDocs{doc_ids, doc_vals}, D, K,
                           q_ids, q_vals, Qm, L, out, stream);
}
