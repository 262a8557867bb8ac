// ELL sparse match: the port's backend "gpu".
//
// Replaces src/repro/kernels/sparse_match.py::_kernel (backend "pallas"),
// which builds a match matrix eq[d*k, q] = (doc_id == q_id) and runs
// eq @ q_vals on the MXU. Here each document slot instead looks up the run
// of its word id in the merged query stream (match.cuh): one warp a
// document row, lanes over the row's K slots, the query ids of a tile in
// shared memory.
//
// Bound on the H100: bytes. At 2^20 docs x nnz_pad 128 every id must be
// read (2^27 x 4 B = 0.54 GB) and the value of each slot that holds a
// word (~0.22 GB for the paper's ~60 words a doc; 0.54 GB if full), about
// 0.23-0.32 ms at 3.35 TB/s; the query stream and the [D, L] output add
// a few percent. The arithmetic (one multiply-add per matched slot and
// column) is far below the card's rate, so the design keeps the loads
// coalesced (lanes on neighbouring slots), reads no value of a pad slot,
// and never re-reads a row from device memory for one query tile.
#include "match.cuh"

extern "C" int sparse_match_launch(int device, const int* doc_ids,
                                   const float* doc_vals, const int* q_ids,
                                   const float* q_vals, float* out, int D,
                                   int K, int Qm, int L, cudaStream_t stream) {
  rsm::EllDocs docs{doc_ids, doc_vals};
  return rsm::launch_match(device, docs, D, K, q_ids, q_vals, Qm, L, out,
                           stream);
}
