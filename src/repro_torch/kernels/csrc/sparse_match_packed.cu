// Packed-word sparse match: the port's backend "gpu_packed".
//
// Replaces src/repro/kernels/sparse_match_packed.py::_kernel (backend
// "pallas_packed"): the same match as sparse_match.cu, with each document
// slot a Fig. 8 word (wordID << 12 | count, pad 0xFFFFFFFF) unpacked in
// the kernel by a shift and a mask.
//
// Bound on the H100: bytes. At 2^20 docs x nnz_pad 128 the kernel reads
// 2^27 x 4 B = 0.54 GB of words once, about 0.16 ms at 3.35 TB/s: half
// the ELL kernel's bytes, which is the point of the format.
#include "match.cuh"

extern "C" int sparse_match_packed_launch(int device,
                                          const uint32_t* docs_packed,
                                          const int* q_ids,
                                          const float* q_vals, float* out,
                                          int D, int K, int Qm, int L,
                                          cudaStream_t stream) {
  rsm::PackedDocs docs{docs_packed};
  return rsm::launch_match(device, docs, D, K, q_ids, q_vals, Qm, L, out,
                           stream);
}
