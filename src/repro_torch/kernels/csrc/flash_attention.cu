// Flash attention, forward: softmax(q k^T / sqrt(hd), causal and window
// mask) v with an online softmax, the port's kernel for LM prefill.
//
// Replaces src/repro/kernels/flash_attention.py::_kernel (driven there by
// flash_attention and flash_attention_gqa), which walks a (bh, q block,
// kv block) grid in order on one TPU core and carries the running max,
// running sum and accumulator in VMEM scratch across the kv axis. Here the
// kv axis is a loop inside the block, one block a (batch, head, 64-row
// query tile); tiles wholly above the diagonal are skipped (the TPU
// kernel's `run`), and the grid starts with the longest query tiles.
//
// Layout: q and o are [B, S, H, hd], k and v [B, Sk, KV, hd], read by
// element strides with hd contiguous; head h reads kv head h / (H / KV),
// so grouped-query attention needs no repeated copy of k and v. The
// [BH, S, hd] entry point is the same kernel with H = KV = 1. Any S and
// Sk: rows past S and keys past Sk are masked inside the kernel. Sk != S
// is cross-attention (llama-3.2-vision's queries over its 1600 image
// tokens, the reference's jnp blockwise attention at any Sk); the
// wrapper allows it only non-causal and without a window, where no
// test compares a query's position with a key's.
//
// Numerics, as in the TPU kernel: scores from q and k summed in f32,
// scaled by 1/sqrt(hd); positions above the diagonal set to -1e30;
// running max and sum in f32; p rounded to v's dtype before p·v, with f32
// accumulation; the output is acc / max(l, 1e-30), cast to q's dtype.
// expf (not __expf), IEEE division, and no FMA contraction (built with
// -fmad=false).
//
// Sliding window (gemma3's local layers; the reference's _attn_mask in
// src/repro/models/layers.py, which the TPU kernel does not have): with
// window w > 0 a key at position dk is kept for the query at dq iff
// dq - dk < w, on top of the causal test when causal. Both instances
// start a block's key loop at the tile that holds key q0 - w + 1, so the
// tiles below the band are never loaded, and mask per element only the
// tiles that cross the band's lower edge. The window is a template
// flag of each instance (kWindow): w = 0 launches the global instance,
// whose loop is the one without a window, test for test. A row that sees no key of a tile (below its own band, in a
// tile another row of the block needs) gets p = 1 from -1e30 - -1e30
// there; its first real score then sets alpha = exp(-1e30 - m) = 0,
// which clears that tile's sum and accumulator exactly, as in the plain
// version and the reference.
//
// Bound on the H100 at the qwen2-0.5b prefill shape (B 4, S 1024, 14 heads
// over 2 kv heads, hd 64, bf16): operations. Causal attention needs
// 2·B·H·S²·hd = 7.5 GFLOP against 16.8 MB of q, k, v and o: 7.6 us on the
// bf16 tensor cores (989 TFLOP/s) against 5.0 us at 3.35 TB/s.
//
// Causal query offset (seq_shard_attn: a rank's block of the query rows
// against the keys up to its last row): query row i of the call sits at
// key position q_offset + i, and the wrapper passes Sk = q_offset + S.
// The causal test is key > q_offset + row, the window's q_offset + row -
// key >= window, and a block's key loop runs from the band's first tile
// to min(Sk, q_offset + q0 + kBlockQ): the tiles of the full call's block
// at q_offset + q0, in the same order, so where q_offset is a multiple of
// kBlockQ the rows equal the full call's bit for bit. q_offset 0 is the
// plain causal call.
//
// Log-sum-exp for the backward: where the caller passes an f32 `lse`
// [B, H, S] (the training forward's autograd Function), both instances
// also write each query row's m + log(max(l, 1e-30)) there, in the
// scaled-score units the scores are in: the reference's _flash_fwd lse
// (src/repro/models/layers.py), which its _flash_b reads back. The TPU
// kernel has no backward and writes no lse. With a null `lse` (serving)
// nothing more is written: one test on a kernel argument in the epilogue.
// Rows past S are not written; in the wgmma instance one thread of a lane
// quad writes the row (the quad's four hold the same m and l), and at hd
// 256 only the first of the two warpgroups (both hold the row's
// statistics).
//
// Two instances; kernels/flash_attention.py::design picks one from the
// dtype and head dim alone, and never falls back from one to the other.
//
// wgmma (bfloat16, hd 16, 32, 64, 128 and 256), the main path's. The first
// design ran one thread a query row on the CUDA cores: scalar f32
// products with a shared-memory load per multiply-add, K and V converted
// to f32 and staged synchronously, scores written to shared memory and
// read back, 198 registers a thread in 64-thread blocks. Here:
//  - Both products run on the tensor cores, one warpgroup (128 threads)
//    a 64-row query tile: s = q·kᵀ as wgmma m64n64k16 with q and k from
//    shared memory (K-major, k in its natural [keys, hd] layout), then
//    o += p·v as wgmma m64n{hd}k16 with p from registers and v from
//    shared memory read MN-major through the instruction's transpose
//    flag, so v is never transposed in memory. f32 accumulators.
//  - K and V tiles (64 keys) stay bf16 and arrive by cp.async into two
//    stages: tile j+1's copy is issued before tile j's products and
//    waited for only when j+1 is consumed. cp.async and not TMA: the
//    model hands over q, k and v as strided views of one projection, a
//    row is only 32-256 bytes, and a tensor map would have to be encoded
//    on the host for every call and view; 128 threads issue a tile's
//    16-byte chunks in 2-16 instructions each, zero-filling rows past S
//    (src-size 0), which is the ragged-edge mask for free. Each 16-byte
//    chunk goes where the 32/64/128-byte swizzle of the wgmma descriptor
//    expects it (rows of 2·hd bytes), so wgmma reads without bank
//    conflicts. At hd 128 a row is 256 bytes, two 128-byte swizzle
//    atoms, so each tile is stored as two 64-column sub-tiles (Tile<HD>):
//    q·kᵀ's k-steps 4-7 start in the second, and p·v reads v's N = 128
//    across both through the MN-major descriptor's leading byte offset.
//    At hd 256 a row is four atoms: four sub-tiles, and q·kᵀ's 16 k-steps
//    walk them; p·v's N = 256 is split over two warpgroups (Split), the
//    first reading sub-tiles 0-1, the second 2-3.
//  - The online softmax stays in registers on the accumulator layout: a
//    thread holds 2 rows x 16 scores, and a row's max and sum are reduced
//    over the 4 threads of a lane quad by shuffles; nothing is staged in
//    shared memory. p's f32 fragment, rounded to bf16 pairs, is the A
//    operand of p·v as it stands: the rounding to v's dtype is the
//    conversion wgmma needs. The -1e30 mask is applied only on tiles
//    that cross the diagonal or S.
//  - Block shape: kBlockK 64 (the plain version's tiles, and 32 f32
//    score registers a thread), one warpgroup a block and no producer
//    warp: a block's copies are 8 cp.async a thread a tile (hd 64). A
//    block takes smem_bytes<64>() = 41,984 bytes of shared memory (five
//    8 KB tiles, q and two stages of k and v, and 1 KB of alignment
//    slack) and, at 128 registers a thread (ptxas -v, hd 64), 16,384 of
//    an SM's 65,536 registers: the registers allow four blocks an SM and
//    the 228 KB of shared memory five, so four share an SM, whose
//    softmax and products interleave; the 896 query tiles of the
//    prefill shape are ~1.7 waves of 4 x 132 = 528 blocks. Two stages
//    cover the copy of one tile with the products of the last. Two
//    warpgroups a block sharing each K/V tile (half the copies a query
//    row) measured slower, and so did three: the loop is bound by the
//    softmax's instruction issue (34 accurate expf a thread a tile, 32
//    for p and 2 for the rescale), not by copies.
//  - At hd 128 (qwen3, internlm2, qwen3-moe): 64 accumulator and 32
//    score registers a thread, 169 registers in all (ptxas -v, no
//    spills), so three blocks an SM by registers; smem_bytes<128>() =
//    82,944 bytes (five 16 KB tiles) above the 48 KB default, so two
//    by shared memory. The 2048 query tiles of qwen3-4b's prefill shape
//    (B 4, S 1024, 32 heads over 8) are ~7.8 waves of 2 x 132 = 264
//    blocks; the bound there is 34.4 GFLOP, 0.035 ms at 989 TFLOP/s.
//  - At hd 256 (gemma3): smem_bytes<256>() = 164,864 bytes (five 32 KB
//    tiles), one block an SM. With one warpgroup a block, a thread held
//    128 accumulator floats beside the 32 scores: 255 registers and 160
//    bytes spilled, and 4 warps an SM. So a block runs two warpgroups
//    that share each K/V tile: both compute the block's 64 x 64 scores
//    and softmax (the q·kᵀ products twice, 1.5x the tensor work of one),
//    and each accumulates half of p·v's N = 256, 64 floats a thread: 170
//    registers, no spills, 8 warps an SM, one warpgroup's softmax beside
//    the other's products. Measured 13% faster than one warpgroup at
//    gemma3's prefill shape, 6% with its window
//    (benchmarks/port_b4_times.py, H100 80GB HBM3 at 700 W).
//
// simt (float32 at every head dim, and bfloat16 at hd 8, below wgmma's
// bf16 depth of 16), on the CUDA cores. The f32 path is the accuracy
// reference of chip_smoke.py's whole-model checks (ATTN_TOL 2e-5,
// LM_ATOL 1e-3, GRAD_TOL 1e-5, LSE_TOL 1e-4), so it stays full f32: no
// tensor cores and no TF32 in any form (TF32 keeps ~3 decimal digits,
// and 3xTF32 would also need v transposed in shared memory).
//  - Bound: operations, at 67 TFLOP/s (132 SMs x 128 f32 lanes x 2 x
//    1.98 GHz). The VLM's cross layer trained on a rank's heads (q [1,
//    1024, 16, 128] over k, v [1, 1600, 2, 128]) needs 13.4 GFLOP, 0.2003
//    ms, against 0.006 ms for its 20.1 MB (q, k, v, o, lse) at 3.35 TB/s. The first design
//    (one thread a query row, its q row and accumulator in registers, a
//    shared-memory load for each multiply-add, scores through a
//    shared-memory column, synchronous f32 staging, 64-thread blocks)
//    ran that in 2.5251 ms, 12.6x the bound, and spilled 308 bytes a
//    thread at hd 128, 2428 at hd 256.
//  - Block: one (64-row query tile, head, batch), 128 threads (256 at
//    hd 256). Thread t = KG rg + kg (KG = 8, or 16 at hd 256) holds 4
//    query rows, rg + 16 i: their scores against 64 / KG keys of a
//    tile, kg + KG j (32 or 16 registers), and their outputs at hd / KG
//    columns (64 accumulators at hd 128 and 256). A row's KG threads are
//    consecutive lanes of one warp; its max and sum reduce by xor
//    shuffles.
//  - Shared memory: q, K and V tiles in their [64][hd] layout, 16-byte
//    chunk c of row r at c ^ (r mod 8), so the 8 rows a quarter-warp
//    reads at one chunk fall on 8 bank groups; a thread's rows (rg + 16
//    i) share one swizzle, and so do its keys (kg + KG j). q·kᵀ reads q
//    and k as 16-byte loads along hd: cp.async cannot transpose, and 4
//    rows x 8 keys x 4 elements take the 128 multiply-adds for 12 loads
//    that a transposed layout would. p goes through one [64][64] f32 tile
//    (chunks swizzled by row) into p·v, which reads 4 keys of p and each
//    key's v row in 16-byte vectors: 20 loads for 256 multiply-adds at
//    hd 128.
//  - Copies: cp.async in 16-byte chunks, zero-filled past S and Sk (the
//    ragged edge's mask). Two stages of K and V at hd <= 64 (tile j + 1
//    lands during tile j). One stage at hd 128 and 256: K(j + 1)'s copy
//    is issued once q·kᵀ(j) has read K, V(j + 1)'s once p·v(j) has read
//    V, so each overlaps about half a tile's work. q, K, V and p take
//    114,688 bytes at hd 128 (two blocks an SM; 234 registers, 244-252
//    with one-element copies) and 212,992 at hd 256 (one block; 187-189,
//    193-207); ptxas -v: no instance spills. Views that are not 16-byte aligned, or whose
//    strides are not whole 16-byte chunks, copy one element at a time
//    (4-byte cp.async for f32, a plain load and store for bf16's 2
//    bytes): an instance of its own (kWide), which launch() picks from
//    the pointers and strides; as a runtime argument of one instance the
//    second copy loop cost the hd-128 instance registers and 4 bytes of
//    spill.
//  - Arithmetic: each product an explicit __fmaf_rn, one instruction and
//    one rounding (-fmad=false forbids only the compiler's contraction of
//    a * b + c, which would otherwise issue as an FMUL and an FADD);
//    expf, IEEE division and the build flags as before. p rounded to v's
//    dtype before p·v (bf16 at hd 8 converts on the read from shared
//    memory). The -1e30 mask only on tiles that cross the diagonal, Sk
//    or the window's lower edge; keys past Sk score -inf, so p = 0
//    exactly, as if the tile ended at Sk.
//  - Launch order: grid (H, B, query tiles), heads and batches fastest,
//    so every (head, batch)'s longest query tile starts before any
//    shorter one (past gridDim.z's 65535 tiles, the (tiles, H, B) order).
//    Against tiles first, in turns on one card: 24% faster at qwen2's
//    and 27% at qwen3-4b's causal prefill shapes, the cross shapes the
//    same, 3% and 8% slower at gemma3's global and windowed (one block
//    an SM, and a wave then spans every (head, batch)'s keys).
//  - Measured (benchmarks/port_b4_times.py --dtype float32, graph
//    replay, parent and change in turns; NVIDIA H100 80GB HBM3, 700.00
//    W), ms, x the bound, and the first design's ms: qwen2-0.5b [4, 1024,
//    14/2, 64] causal 0.2589, 2.31x, 0.8543; qwen3-4b [4, 1024, 32/8,
//    128] causal with the lse 1.0721, 2.09x, 7.9742; gemma3-4b [4, 2048,
//    8/4, 256] causal 2.4766, 2.41x, 24.8504, and with window 1024
//    1.9247, 2.50x, 17.7262; the VLM's cross [4, 1024, 64/8, 128] over
//    1600 keys 6.1362, 1.91x, 40.9341, and on a rank's heads with the lse
//    0.4048, 2.02x, 2.5223. SDPA in f32 (its MATH backend, allow_tf32
//    False) is 1.45-4.70x slower at each of these shapes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "error.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF

// Element strides of a [B, S, heads, hd] view; hd has stride 1.
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4 bytes, the same way (cp.async takes no narrower copy)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The CUDA-core instance: float32 at every head dim, bfloat16 at hd 8.
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kBlockQ = 64;         // query rows a block
constexpr int kBlockK = 64;         // keys a tile
constexpr int kRows = 4;            // query rows a thread: rg + 16 i
constexpr int kRowGroups = kBlockQ / kRows;

template <typename T, int HD>
struct Cfg {
  static constexpr int kThreads = HD == 256 ? 256 : 128;
  static constexpr int KG = kThreads / kRowGroups;  // threads a row: 8, 16
  static constexpr int kKeys = kBlockK / KG;        // its keys: kg + KG j
  static constexpr int kCols = HD / KG;             // its columns of o
  static constexpr int VW = kCols < 4 ? kCols : 4;  // columns a vector
  static constexpr int NV = kCols / VW;             // VW kg + VW KG n
  static constexpr int kRowBytes = HD * (int)sizeof(T);
  static constexpr int R = kRowBytes / 16;          // 16-byte chunks a row
  static constexpr int kTileBytes = kBlockK * kRowBytes;
  static constexpr int kStages = HD <= 64 ? 2 : 1;  // K/V tiles in flight
  static constexpr int kSmem =                      // q, K and V, p
      (1 + 2 * kStages) * kTileBytes + kBlockQ * kBlockK * 4;
  static_assert(kKeys * KG == kBlockK && NV * VW == kCols, "tiling");
};

// A [64][HD] tile of T: 16-byte chunk c of row r sits at chunk c ^ x(r),
// so that 8 consecutive rows read at one chunk fall on 8 different
// 16-byte bank groups; rows of fewer than 8 chunks spread the 8 rows over
// their R chunks (r·R/8 mod R).
template <int R>
__device__ __forceinline__ int swizzle(int r) {
  return R >= 8 ? (r & 7) : ((r * R) >> 3) & (R - 1);
}
// byte offset, within its row, of the element at byte b of a row whose
// swizzle is x
__device__ __forceinline__ int chunk_off(int b, int x) {
  return (((b >> 4) ^ x) << 4) | (b & 15);
}

// Rows row0.. of a [rows, HD] slice (row stride `stride` elements) into a
// swizzled tile; rows at or past `rows` are zeros. kWide: 16-byte
// cp.async chunks (pointer 16-byte aligned, strides multiples of 16
// bytes); else one element a copy: 4-byte cp.async for float, a plain
// load and store for bfloat16's 2 bytes.
template <typename T, int HD, bool kWide>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* base,
                                          long long stride, int row0,
                                          int rows, int tid) {
  using C = Cfg<T, HD>;
  if constexpr (kWide) {
    for (int i = tid; i < kBlockK * C::R; i += C::kThreads) {
      const int r = i / C::R, c = i % C::R;
      const bool live = row0 + r < rows;
      const T* src = base + (live ? (row0 + r) * stride + c * (16 / (int)
                                    sizeof(T)) : 0);
      cp_async16(smem_addr(dst + r * C::kRowBytes +
                           chunk_off(c * 16, swizzle<C::R>(r))),
                 src, live ? 16 : 0);
    }
  } else {
    for (int i = tid; i < kBlockK * HD; i += C::kThreads) {
      const int r = i / HD, e = i % HD;
      const bool live = row0 + r < rows;
      const T* src = base + (live ? (row0 + r) * stride + e : 0);
      unsigned char* d = dst + r * C::kRowBytes +
                         chunk_off(e * (int)sizeof(T), swizzle<C::R>(r));
      if constexpr (sizeof(T) == 4)
        cp_async4(smem_addr(d), src, live ? 4 : 0);
      else
        *reinterpret_cast<T*>(d) = live ? *src : from_f32<T>(0.f);
    }
  }
}

// N consecutive elements (N = 1, 2 or 4, within one 16-byte chunk) from
// shared memory, as f32
template <typename T, int N>
__device__ __forceinline__ void ld(const unsigned char* p, float (&x)[N]) {
  if constexpr (sizeof(T) == 4 && N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  } else if constexpr (sizeof(T) == 4 && N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x, x[1] = f.y;
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] = to_f32(reinterpret_cast<const T*>(p)[e]);
  }
}

// One block a (64-row query tile, head, batch); thread t = KG rg + kg holds
// query rows rg + 16 i (i < 4): their scores against keys kg + KG j of a
// tile, and their outputs at columns VW kg + VW KG n (+ < VW). A row's KG
// threads are consecutive lanes of one warp, so its max and sum reduce by
// xor shuffles.
template <typename T, int HD, bool kWindow, bool kWide>
__global__ void __launch_bounds__(Cfg<T, HD>::kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int S, int Sk, int H, int G, Strides sq,
          Strides sk, Strides sv, Strides so, int causal, int window,
          int q_offset, float scale) {
  using C = Cfg<T, HD>;
  constexpr int KG = C::KG, RB = C::kRowBytes, ES = (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_q = smem;
  unsigned char* s_k = s_q + C::kTileBytes;                // kStages tiles
  unsigned char* s_v = s_k + C::kStages * C::kTileBytes;   // kStages tiles
  // p [row][key] in f32; row r's 16-byte chunk c at c ^ g(r)
  float* s_p = reinterpret_cast<float*>(s_v + C::kStages * C::kTileBytes);

  const int tid = threadIdx.x, rg = tid / KG, kg = tid % KG;
  // grid (H, B, query tiles), or (query tiles, H, B) past gridDim.z's
  // 65535 tiles; the longest tiles first
  const int tiles = (S + kBlockQ - 1) / kBlockQ;
  const bool tiles_z = tiles <= 65535;
  const int h = tiles_z ? blockIdx.x : blockIdx.y;
  const int b = tiles_z ? blockIdx.y : blockIdx.z, kvh = h / G;
  const int q0 = (tiles - 1 - (tiles_z ? blockIdx.z : blockIdx.x)) * kBlockQ;
  const int p0 = q_offset + q0;                  // its first key position
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  // causal: a tile runs iff its first key is at or below the block's
  // last row (the TPU kernel's `run`); window: tiles [t0, t_end) from
  // the one that holds key p0 - window + 1, the band's first
  const int k_end = causal ? min(Sk, p0 + kBlockQ) : Sk;
  const int t_end = (k_end + kBlockK - 1) / kBlockK;
  const int t0 = kWindow ? max(0, p0 - window + 1) / kBlockK : 0;

  // q with K, then V: with one stage V's copy has a group of its own
  load_tile<T, HD, kWide>(s_q, qb, sq.s, q0, S, tid);
  load_tile<T, HD, kWide>(s_k, kb, sk.s, t0 * kBlockK, Sk, tid);
  if constexpr (C::kStages == 1) cp_async_commit();
  load_tile<T, HD, kWide>(s_v, vb, sv.s, t0 * kBlockK, Sk, tid);
  cp_async_commit();

  // the swizzles this thread reads q and K under: its rows rg + 16 i
  // share one, and so do its keys kg + KG j (16 i and KG j are multiples
  // of 8 rows); p's rows rg + 16 i share g
  const int xq = swizzle<C::R>(rg), xk = swizzle<C::R>(kg);
  const int g = (rg * KG / 4) & 7;
  const unsigned char* q_row = s_q + rg * RB;
  float* p_row = s_p + rg * kBlockK;

  float acc[kRows][C::kCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = t0; t < t_end; ++t) {
    const int stage = C::kStages == 2 ? (t - t0) & 1 : 0;
    const unsigned char* kt = s_k + stage * C::kTileBytes;
    const unsigned char* vt = s_v + stage * C::kTileBytes;
    const bool more = t + 1 < t_end;
    if constexpr (C::kStages == 2) {
      // the next tile's copy is issued before this tile's products
      if (more) {
        const int next = (t - t0 + 1) & 1;
        load_tile<T, HD, kWide>(s_k + next * C::kTileBytes, kb, sk.s,
                                (t + 1) * kBlockK, Sk, tid);
        load_tile<T, HD, kWide>(s_v + next * C::kTileBytes, vb, sv.s,
                                (t + 1) * kBlockK, Sk, tid);
        cp_async_commit();
        cp_async_wait<1>();                 // all but the newest group
      } else {
        cp_async_wait<0>();
      }
    } else {
      cp_async_wait<1>();                   // q and K(t); V(t) may not be
    }
    __syncthreads();

    // s = q kᵀ: 4 rows x kKeys keys a thread, 4 elements of hd a step
    const unsigned char* k_row = kt + kg * RB;
    float s[kRows][C::kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < C::kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < HD; d0 += (HD < 32 ? HD : 32)) {
#pragma unroll
      for (int d = d0; d < d0 + (HD < 32 ? HD : 32); d += 4) {
        float qv[kRows][4];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          ld<T, 4>(q_row + i * kRowGroups * RB + chunk_off(d * ES, xq),
                   qv[i]);
        const int ko = chunk_off(d * ES, xk);
#pragma unroll
        for (int j = 0; j < C::kKeys; ++j) {
          float kv[4];
          ld<T, 4>(k_row + j * KG * RB + ko, kv);
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[i][j] = __fmaf_rn(qv[i][e], kv[e], s[i][j]);
        }
      }
    }
    if constexpr (C::kStages == 1) {
      __syncthreads();                      // K(t) is read
      if (more) {
        load_tile<T, HD, kWide>(s_k, kb, sk.s, (t + 1) * kBlockK, Sk, tid);
        cp_async_commit();
      }
    }

    // scale; -1e30 on masked keys and -inf on keys past Sk, tested only
    // on a tile that crosses the diagonal, Sk or the band's lower edge
    const int k0 = t * kBlockK;
    const bool edge = (causal && k0 + kBlockK - 1 > p0) ||
                      k0 + kBlockK > Sk ||
                      (kWindow && p0 + kBlockQ - 1 - k0 >= window);
    float alpha[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int pos = p0 + rg + kRowGroups * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < C::kKeys; ++j) {
        float x = s[i][j] * scale;
        if (edge) {
          const int key = k0 + kg + KG * j;
          if (key >= Sk)
            x = __int_as_float(0xff800000);  // -inf: p = 0, as if absent
          else if ((causal && key > pos) ||
                   (kWindow && pos - key >= window))
            x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 1; w < KG; w *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < C::kKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_sum += p;
        s[i][j] = to_f32(from_f32<T>(p));   // p in v's dtype
      }
#pragma unroll
      for (int w = 1; w < KG; w *= 2)
        p_sum += __shfl_xor_sync(0xffffffffu, p_sum, w);
      l[i] = l[i] * alpha[i] + p_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < C::kKeys; ++j) {
        const int key = kg + KG * j;
        p_row[i * kRowGroups * kBlockK + ((((key >> 2) ^ g) << 2) |
                                          (key & 3))] = s[i][j];
      }
    }
    if constexpr (C::kStages == 1) {
      if (more)
        cp_async_wait<1>();                 // V(t); K(t + 1) may not be
      else
        cp_async_wait<0>();
    }
    __syncthreads();                        // p is written, V(t) is here

    // o = o·alpha + p v: 4 keys of p a read, each key's v row in VW-wide
    // vectors; 8 keys a step, so each key's swizzle is known
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < C::kCols; ++c) acc[i][c] *= alpha[i];
    const int vb0 = C::VW * kg * ES;         // its first column, in bytes
#pragma unroll 2
    for (int j0 = 0; j0 < kBlockK; j0 += 8) {
#pragma unroll
      for (int jh = 0; jh < 8; jh += 4) {
        float pj[kRows][4];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          ld<float, 4>(reinterpret_cast<const unsigned char*>(
                           p_row + i * kRowGroups * kBlockK +
                           ((((j0 + jh) >> 2) ^ g) << 2)),
                       pj[i]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const unsigned char* v_row = vt + (j0 + jh + jj) * RB;
          const int x = swizzle<C::R>(jh + jj);   // = swizzle(j0 + jh + jj)
#pragma unroll
          for (int n = 0; n < C::NV; ++n) {
            float vv[C::VW];
            ld<T, C::VW>(v_row + chunk_off(vb0, x) + n * C::VW * KG * ES,
                         vv);
#pragma unroll
            for (int i = 0; i < kRows; ++i)
#pragma unroll
              for (int e = 0; e < C::VW; ++e)
                acc[i][n * C::VW + e] =
                    __fmaf_rn(pj[i][jj], vv[e], acc[i][n * C::VW + e]);
          }
        }
      }
    }
    __syncthreads();                        // p and V(t) are read
    if constexpr (C::kStages == 1) {
      if (more) {
        load_tile<T, HD, kWide>(s_v, vb, sv.s, (t + 1) * kBlockK, Sk, tid);
        cp_async_commit();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + rg + kRowGroups * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* op = o + b * so.b + row * so.s + h * so.h;
#pragma unroll
    for (int n = 0; n < C::NV; ++n)
#pragma unroll
      for (int e = 0; e < C::VW; ++e)
        op[C::VW * (kg + KG * n) + e] =
            from_f32<T>(acc[i][n * C::VW + e] / denom);
    // [B, H, S]; one thread of the row's KG writes it
    if (lse && kg == 0)
      lse[((long long)b * H + h) * S + row] = m[i] + logf(denom);
  }
}

template <typename T, int HD, bool kWindow, bool kWide>
cudaError_t launch_as(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int S, int Sk, int H, int KV,
                      const long long* st, int causal, int window,
                      int q_offset, float scale, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  const auto kernel = flash_fwd<T, HD, kWindow, kWide>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  // all of the SM's shared memory, so that two hd-128 blocks share one
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  // heads and batches vary fastest in launch order, so that every (head,
  // batch)'s longest query tile starts before any shorter one
  const int tiles = (S + kBlockQ - 1) / kBlockQ;
  const dim3 grid = tiles <= 65535 ? dim3(H, B, tiles) : dim3(tiles, H, B);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, Sk, H, H / KV,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

// the global instance for window 0, the windowed one otherwise; the one
// with 16-byte copies where q, k and v are 16-byte aligned with (b, s,
// head) strides of whole 16-byte chunks, one-element copies otherwise
template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int Sk, int H, int KV,
                   const long long* st, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream) {
  constexpr long long kEl = 16 / sizeof(T);
  const void* views[3] = {q, k, v};
  bool wide = true;
  for (const void* p : views)
    wide = wide && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (int i = 0; i < 9; ++i) wide = wide && st[i] % kEl == 0;
  const auto as = window > 0
                      ? (wide ? launch_as<T, HD, true, true>
                              : launch_as<T, HD, true, false>)
                      : (wide ? launch_as<T, HD, false, true>
                              : launch_as<T, HD, false, false>);
  return as(q, k, v, o, lse, B, S, Sk, H, KV, st, causal, window, q_offset,
            scale, stream);
}

// float32 at every head dim
cudaError_t launch_f32(int hd, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int S, int Sk, int H,
                       int KV, const long long* st, int causal, int window,
                       int q_offset, float scale, cudaStream_t stream) {
  switch (hd) {
    case 8:
      return launch<float, 8>(q, k, v, o, lse, B, S, Sk, H, KV, st, causal,
                              window, q_offset, scale, stream);
    case 16:
      return launch<float, 16>(q, k, v, o, lse, B, S, Sk, H, KV, st, causal,
                               window, q_offset, scale, stream);
    case 32:
      return launch<float, 32>(q, k, v, o, lse, B, S, Sk, H, KV, st, causal,
                               window, q_offset, scale, stream);
    case 64:
      return launch<float, 64>(q, k, v, o, lse, B, S, Sk, H, KV, st, causal,
                               window, q_offset, scale, stream);
    case 128:
      return launch<float, 128>(q, k, v, o, lse, B, S, Sk, H, KV, st, causal,
                                window, q_offset, scale, stream);
    case 256:
      return launch<float, 256>(q, k, v, o, lse, B, S, Sk, H, KV, st, causal,
                                window, q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// The tensor-core instance: bf16, head dims 16, 32, 64, 128 and 256.
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kBlockQ = 64;         // query rows a block: one wgmma M
constexpr int kBlockK = 64;         // keys a tile: N of q·kᵀ, K of p·v
constexpr int kThreads = 128;       // one warpgroup
constexpr int kStages = 2;          // K/V tiles in flight

// A [64 rows][HD] bf16 tile in shared memory. A row is W = 2·HD bytes;
// the widest swizzle atom row is 128 bytes, so a tile is stored as
// kAtoms sub-tiles of [64 rows][A bytes], A = min(W, 128): one at hd 16,
// 32 and 64, two 64-column halves at hd 128 and four 64-column quarters
// at hd 256, each 8 KB. In a sub-tile
// the 16-byte chunks are swizzled as wgmma's 32/64/128-byte modes read
// them: address bits [4, 4 + log2(A/16)) ^= bits [7, ...).
template <int HD>
struct Tile {
  static constexpr int W = 2 * HD;
  static constexpr int A = W < 128 ? W : 128;    // bytes a sub-tile row
  static constexpr int kAtoms = W / A;           // sub-tiles along hd
  static constexpr int kChunks = W / 16;         // 16-byte chunks a row
  static constexpr int kAtomChunks = A / 16;
  static constexpr int kAtomBytes = kBlockQ * A;
  static constexpr int kBytes = kBlockQ * W;     // 2, 4, 8, 16 or 32 KB
  // descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr int kLayout = A == 128 ? 1 : A == 64 ? 2 : 3;
  static constexpr int kSBO = 8 * A;             // between 8-row groups
  // MN-major (v in p·v, N = hd, or 128 at hd 256): bytes between the
  // sub-tiles along N; K-major reads and a single sub-tile leave it
  // unused (16, field 1)
  static constexpr int kLBO = kAtoms > 1 ? kAtomBytes : 16;
  // where chunk c of row r lies
  __device__ static uint32_t offset(int r, int c) {
    const uint32_t off = r * A + (c % kAtomChunks) * 16;
    return (c / kAtomChunks) * kAtomBytes +
           (off ^ ((off >> 3) & ((kAtomChunks - 1) << 4)));
  }
  // K-major start of columns [16 kk, 16 kk + 16): 32 bytes into a row,
  // in the sub-tile that holds them
  __device__ static uint32_t kstep(int kk) {
    return (kk * 32 / A) * kAtomBytes + (kk * 32) % A;
  }
};

// makes this thread's completed shared-memory writes visible to wgmma,
// which reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of wgmma's registers across
// the asynchronous instruction
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout type (bits 62-63). With a swizzle,
// K-major: SBO steps 8-row groups along M/N, LBO is unused; MN-major:
// SBO steps 8-row groups along K, LBO steps swizzle atoms along M/N (the
// PTX ISA's canonical layouts, ((T,8,m),(8,k)) : ((1,T,LBO),(8T,SBO))
// for 128 bytes).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t sbo,
                                               int layout,
                                               uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

// wgmma, bf16 x bf16 -> f32, M 64, K 16. ss: A and B from shared memory
// (both K-major); rs: A from registers, B from shared memory MN-major
// (transposed), adding to d.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, "
      "1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n16(float (&d)[8],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12,"
      " p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, "
      "%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
        "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
        "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_m64n16(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_m64n32(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_m64n64(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  wgmma_rs_m64n128(d, a, b);
}

// Warpgroups a block: one up to hd 128; two at hd 256, each computing
// the block's scores and owning half of p·v's N, so that a thread holds
// 64 accumulator floats, as at hd 128, and not 128.
template <int HD>
struct Split {
  static constexpr int kGroups = HD == 256 ? 2 : 1;
  static constexpr int kN = HD / kGroups;       // p·v's N a warpgroup
  static constexpr int kBlockThreads = kThreads * kGroups;
};

// Rows row0.. of a [S, HD] slice (row stride `stride` elements) into a
// swizzled tile; rows at or past S are zeros.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          long long stride, int row0, int S,
                                          int tid) {
  using T = Tile<HD>;
  constexpr int kNT = Split<HD>::kBlockThreads;
#pragma unroll
  for (int i = 0; i < T::kChunks * kBlockQ / kNT; ++i) {
    const int e = tid + i * kNT;
    const int r = e / T::kChunks, c = e % T::kChunks;
    const bool live = row0 + r < S;
    const __nv_bfloat16* src =
        base + (live ? (row0 + r) * stride + c * 8 : 0);
    cp_async16(dst + T::offset(r, c), src, live ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// One block a (head, batch, 64-row query tile), one warpgroup (two at hd
// 256, Split). Thread t of warp w of a warpgroup owns query rows 16w +
// t%32/4 and that + 8 of the tile, and in each 8-column group of an
// accumulator the columns 2(t%4) and + 1.
template <int HD, bool kWindow>
__global__ void __launch_bounds__(Split<HD>::kBlockThreads)
flash_fwd_wgmma(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int S, int Sk, int G, Strides sq, Strides sk, Strides sv,
                Strides so, int causal, int window, int q_offset,
                float scale) {
  using T = Tile<HD>;
  using P = Split<HD>;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on 1024-byte boundaries (the 128-byte mode's
  // pattern repeats every 8 rows of 128 bytes)
  const uint32_t s_q = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = s_q + T::kBytes;                    // kStages tiles
  const uint32_t s_v = s_k + kStages * T::kBytes;          // kStages tiles

  const int tid = threadIdx.x, lane = tid % 32;
  // this thread's warpgroup and its index there
  const int g = P::kGroups > 1 ? tid / kThreads : 0;
  const int warp = (P::kGroups > 1 ? tid % kThreads : tid) / 32;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / G;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockQ;   // longest first
  const int p0 = q_offset + q0;                  // its first key position
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + kvh * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + kvh * sv.h;
  // causal: a tile runs iff its first key is at or below the block's
  // last row (the TPU kernel's `run`); window: tiles [t0, t_end) from
  // the one that holds key p0 - window + 1, the band's first
  const int k_end = causal ? min(Sk, p0 + kBlockQ) : Sk;
  const int t_end = (k_end + kBlockK - 1) / kBlockK;
  const int t0 = kWindow ? max(0, p0 - window + 1) / kBlockK : 0;

  load_tile<HD>(s_q, qb, sq.s, q0, S, tid);
  load_tile<HD>(s_k, kb, sk.s, t0 * kBlockK, Sk, tid);
  load_tile<HD>(s_v, vb, sv.s, t0 * kBlockK, Sk, tid);
  cp_async_commit();

  const int r_lo = warp * 16 + lane / 4;    // this thread's first row
  const int c_lo = 2 * (lane % 4);          // its first column of a group
  float acc[P::kN / 2];     // o: this warpgroup's [64, kN] f32 fragment
#pragma unroll
  for (int i = 0; i < P::kN / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = t0; t < t_end; ++t) {
    const int stage = (t - t0) % kStages;
    // the next tile's copy is issued before this tile's products
    if (t + 1 < t_end) {
      const int next = (t - t0 + 1) % kStages;
      load_tile<HD>(s_k + next * T::kBytes, kb, sk.s, (t + 1) * kBlockK,
                    Sk, tid);
      load_tile<HD>(s_v + next * T::kBytes, vb, sv.s, (t + 1) * kBlockK,
                    Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();                   // all but the newest group
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // s = q kᵀ: [64, HD] x [HD, 64], HD / 16 steps of K 16 (each four
    // steps read the next 64-column sub-tile)
    const uint32_t kt = s_k + stage * T::kBytes;
    float s[kBlockK / 2];
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) s[i] = 0.f;
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_m64n64(s,
                      descriptor(s_q + T::kstep(kk), T::kSBO, T::kLayout),
                      descriptor(kt + T::kstep(kk), T::kSBO, T::kLayout),
                      kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    // scale; -1e30 only on a tile that crosses the diagonal, Sk or the
    // window band's lower edge
    const int k0 = t * kBlockK;
    const bool edge = (causal && k0 + kBlockK - 1 > p0) ||
                      k0 + kBlockK > Sk ||
                      (kWindow && p0 + kBlockQ - 1 - k0 >= window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kBlockK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * i + e] * scale;
        if (edge) {
          const int col = k0 + 8 * i + c_lo + (e & 1);
          const int row = p0 + r_lo + 8 * (e >> 1);   // key position
          if (col >= Sk || (causal && col > row) ||
              (kWindow && row - col >= window))
            x = kNegInf;
        }
        s[4 * i + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // a row's 64 scores lie in the 4 threads of a lane quad
    float alpha[2], m_new[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      m_new[j] = fmaxf(m[j], mx[j]);
      alpha[j] = expf(m[j] - m_new[j]);
    }
    // p = exp(s - m) in f32 for the sum, rounded to bf16 (v's dtype) for
    // p·v: the score fragment is already the A fragment of m64k16
    uint32_t pa[kBlockK / 4];
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kBlockK / 8; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p0 = expf(s[4 * i + 2 * j] - m_new[j]);
        const float p1 = expf(s[4 * i + 2 * j + 1] - m_new[j]);
        ps[j] += p0;
        ps[j] += p1;
        pa[2 * i + j] = pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ps[j] += __shfl_xor_sync(0xffffffffu, ps[j], 1);
      ps[j] += __shfl_xor_sync(0xffffffffu, ps[j], 2);
      l[j] = l[j] * alpha[j] + ps[j];
      m[j] = m_new[j];
    }
#pragma unroll
    for (int i = 0; i < P::kN / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // acc += p v: [64, 64] x [64, kN], 4 steps of 16 keys; v's tile is
    // read MN-major (transposed by the instruction, not in memory); at
    // hd 128 N spans both sub-tiles, kLBO apart, and at hd 256 warpgroup
    // g reads sub-tiles 2g and 2g + 1
    const uint32_t vt = s_v + stage * T::kBytes +
                        g * (2 * P::kN / T::A) * T::kAtomBytes;
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
      wgmma_rs<P::kN>(acc, a, descriptor(vt + kk * 16 * T::A, T::kSBO,
                                         T::kLayout, T::kLBO));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    __syncthreads();                        // this stage may be refilled
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + r_lo + 8 * j;
    if (row >= S) continue;
    const float denom = fmaxf(l[j], 1e-30f);
    __nv_bfloat16* op =
        o + b * so.b + row * so.s + h * so.h + g * P::kN + c_lo;
#pragma unroll
    for (int i = 0; i < P::kN / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * i) = __floats2bfloat162_rn(
          acc[4 * i + 2 * j] / denom, acc[4 * i + 2 * j + 1] / denom);
    // [B, H, S]: gridDim.x is H; one writer a row
    if (lse && g == 0 && lane % 4 == 0)
      lse[((long long)b * gridDim.x + h) * S + row] = m[j] + logf(denom);
  }
}

template <int HD>
size_t smem_bytes() {
  return 1024 + (1 + 2 * kStages) * Tile<HD>::kBytes;  // + alignment slack
}

template <int HD, bool kWindow>
cudaError_t launch_as(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int S, int Sk, int H, int KV,
                      const long long* st, int causal, int window,
                      int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<HD, kWindow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (S + kBlockQ - 1) / kBlockQ);
  flash_fwd_wgmma<HD, kWindow>
      <<<grid, Split<HD>::kBlockThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, S, Sk, H / KV, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

// the global instance for window 0, the windowed one otherwise
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int Sk, int H, int KV,
                   const long long* st, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream) {
  return window > 0
             ? launch_as<HD, true>(q, k, v, o, lse, B, S, Sk, H, KV, st,
                                   causal, window, q_offset, scale, stream)
             : launch_as<HD, false>(q, k, v, o, lse, B, S, Sk, H, KV, st,
                                    causal, window, q_offset, scale, stream);
}

}  // namespace wg
}  // namespace

// The CUDA-core instance. dtype 0: float32 at hd 8, 16, 32, 64, 128 or
// 256; 1: bfloat16 at hd 8 only (the wgmma instance takes bf16 at 16-256).
// S query rows, Sk keys. strides: 12 element strides, (b, s, head) of q,
// k, v and o in turn. window: 0 for global attention, else keys with
// dq - dk < window only. q_offset: query row i's key position is
// q_offset + i (causal; 0 otherwise). lse: null, or f32 [B, H, S],
// contiguous, for each row's log-sum-exp. Returns cudaGetLastError() of
// the launch.
extern "C" int flash_attention_launch(int device, int dtype, int hd,
                                      const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int S, int Sk, int H, int KV,
                                      const long long* strides, int causal,
                                      int window, int q_offset, float scale,
                                      cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  if (Sk <= 0 || KV <= 0 || H % KV != 0 || H > 65535 || B > 65535 ||
      window < 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0)
    return (int)simt::launch_f32(hd, q, k, v, o, lse, B, S, Sk, H, KV,
                                 strides, causal, window, q_offset, scale,
                                 stream);
  if (dtype == 1 && hd == 8)
    return (int)simt::launch<__nv_bfloat16, 8>(q, k, v, o, lse, B, S, Sk,
                                               H, KV, strides, causal,
                                               window, q_offset, scale,
                                               stream);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core instance: bfloat16 only, hd 16, 32, 64, 128 or 256; q,
// k, v and o 16-byte aligned with (b, s, head) strides that are multiples
// of 8 elements. Arguments as flash_attention_launch without the dtype.
extern "C" int flash_attention_wgmma_launch(int device, int hd,
                                            const void* q, const void* k,
                                            const void* v, void* o,
                                            float* lse, int B, int S, int Sk,
                                            int H, int KV,
                                            const long long* strides,
                                            int causal, int window,
                                            int q_offset, float scale,
                                            cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  if (Sk <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || window < 0 ||
      q_offset < 0 || (S + wg::kBlockQ - 1) / wg::kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  switch (hd) {
    case 16:
      return (int)wg::launch<16>(q, k, v, o, lse, B, S, Sk, H, KV,
                                 strides, causal, window, q_offset, scale,
                                 stream);
    case 32:
      return (int)wg::launch<32>(q, k, v, o, lse, B, S, Sk, H, KV,
                                 strides, causal, window, q_offset, scale,
                                 stream);
    case 64:
      return (int)wg::launch<64>(q, k, v, o, lse, B, S, Sk, H, KV,
                                 strides, causal, window, q_offset, scale,
                                 stream);
    case 128:
      return (int)wg::launch<128>(q, k, v, o, lse, B, S, Sk, H, KV,
                                  strides, causal, window, q_offset, scale,
                                  stream);
    case 256:
      return (int)wg::launch<256>(q, k, v, o, lse, B, S, Sk, H, KV,
                                  strides, causal, window, q_offset, scale,
                                  stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
