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
// unless they name longer queries). Here, in the loop of match.cuh
// (table_kernel) that B1 runs too:
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

// B2's doc reader for table_kernel: one packed word a slot.
struct PackedDocs {
  using Slot = uint32_t;
  static constexpr uint32_t kMaxKey = (1u << 20) - 1;  // w >> 12 of a word
  static constexpr bool kFloatVals = false;            // 12-bit counts
  static constexpr int kBlocksPerSm = 4;               // 64 registers a thread
  const uint32_t* __restrict__ words;

  __device__ __forceinline__ Slot load(int r, int k, int D, int K) const {
    return r < D && k < K ? __ldcs(words + (size_t)r * K + k) : kPadWord;
  }
  __device__ __forceinline__ void word(Slot w, int, int, int, int& id,
                                       float& v, bool& ok) const {
    id = (int)(w >> kValBits);
    v = (float)(w & kValMask);
    ok = w != kPadWord;
  }
};

}  // namespace rsm

// The dynamic shared memory a launch for Qm query items and L columns
// takes on card `device` (0 on an error).
extern "C" int sparse_match_packed_smem(int device, int Qm, int L) {
  return rsm::table_smem_bytes<rsm::PackedDocs>(device, Qm, L);
}

extern "C" int sparse_match_packed_launch(int device,
                                          const uint32_t* docs_packed,
                                          const int* q_ids,
                                          const float* q_vals, float* out,
                                          int D, int K, int Qm, int L,
                                          cudaStream_t stream) {
  return rsm::launch_table(device, rsm::PackedDocs{docs_packed}, D, K, q_ids,
                           q_vals, Qm, L, out, stream);
}
