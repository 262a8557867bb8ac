// Flash attention, forward: softmax(q k^T / sqrt(hd), causal mask) v with
// an online softmax, the port's kernel for LM prefill.
//
// Replaces src/repro/kernels/flash_attention.py::_kernel (driven there by
// flash_attention and flash_attention_gqa), which walks a (bh, q block,
// kv block) grid in order on one TPU core and carries the running max,
// running sum and accumulator in VMEM scratch across the kv axis. Here the
// kv axis is a loop inside the block: one block a (batch, head, 64-row
// query tile), one thread a query row holding its q row and f32
// accumulator in registers; 64-key K and V tiles are staged in shared
// memory as f32, and each thread keeps its row of a tile's scores in a
// shared-memory column. Tiles wholly above the diagonal are skipped, and
// the grid starts with the longest (last) query tiles.
//
// Layout: q and o are [B, S, H, hd], k and v [B, S, KV, hd], read by
// element strides with hd contiguous; head h reads kv head h / (H / KV),
// so grouped-query attention needs no repeated copy of k and v. The
// [BH, S, hd] entry point is the same kernel with H = KV = 1.
//
// Numerics, as in the TPU kernel: scores from q and k in f32, scaled by
// 1/sqrt(hd); positions above the diagonal set to -1e30; running max and
// sum in f32; p rounded to v's dtype before p·v, with f32 accumulation;
// the output is acc / max(l, 1e-30), cast to q's dtype. expf (not
// __expf), IEEE division, and no FMA contraction (built with -fmad=false).
//
// Bound on the H100 at the qwen2-0.5b prefill shape (B 4, S 1024, 14 heads
// over 2 kv heads, hd 64, bf16): operations. Causal attention needs
// 2·B·H·S²·hd = 7.5 GFLOP against 16.8 MB of q, k, v and o: 7.6 us on the
// bf16 tensor cores (989 TFLOP/s) against 5.0 us at 3.35 TB/s. This simple
// design runs on the CUDA cores in f32 and is far from that bound; the
// tensor-core (wgmma) redesign is ROADMAP's kernel-redesign queue.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "error.cuh"

namespace {

constexpr int kBlockQ = 64;         // query rows a block, one thread each
constexpr int kBlockK = 64;         // keys a shared-memory tile
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

template <typename T, int HD>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int G,
          Strides sq, Strides sk, Strides sv, Strides so, int causal,
          float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                   // [kBlockK][HD]
  float* vs = ks + kBlockK * HD;      // [kBlockK][HD]
  float* ss = vs + kBlockK * HD;      // [kBlockK][kBlockQ]: a column a row

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int row = q0 + tid;
  const bool live = row < S;

  float qr[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = 0.f;
    acc[d] = 0.f;
  }
  if (live) {
    const T* qp = q + b * sq.b + row * sq.s + h * sq.h;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = to_f32(qp[d]);
  }
  float m = kNegInf, l = 0.f;

  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  // causal: a tile runs iff its first key is at or below the block's
  // last row (the TPU kernel's `run`)
  const int k_end = causal ? min(S, q0 + kBlockQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    const int nk = min(kBlockK, S - k0);
    __syncthreads();                  // the previous tile is consumed
    for (int e = tid; e < nk * HD; e += kBlockQ) {
      const long long j = k0 + e / HD;
      const int d = e % HD;
      ks[e] = to_f32(kb[j * sk.s + d]);
      vs[e] = to_f32(vb[j * sv.s + d]);
    }
    __syncthreads();
    if (!live) continue;
    float m_tile = kNegInf;
    for (int j = 0; j < nk; ++j) {
      const float* kr = ks + j * HD;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) s += qr[d] * kr[d];
      s *= scale;
      if (causal && k0 + j > row) s = kNegInf;
      ss[j * kBlockQ + tid] = s;
      m_tile = fmaxf(m_tile, s);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= alpha;
    float p_sum = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float p = expf(ss[j * kBlockQ + tid] - m_new);
      p_sum += p;
      const float pv = to_f32(from_f32<T>(p));  // p in v's dtype
      const float* vr = vs + j * HD;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] += pv * vr[d];
    }
    l = l * alpha + p_sum;
    m = m_new;
  }
  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = o + b * so.b + row * so.s + h * so.h;
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d] = from_f32<T>(acc[d] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, const long long* st,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kBlockK * HD + kBlockK * kBlockQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd<T, HD><<<grid, kBlockQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H / KV,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, int B, int S, int H, int KV,
                      const long long* st, int causal, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 8:
      return launch<T, 8>(q, k, v, o, B, S, H, KV, st, causal, scale, stream);
    case 16:
      return launch<T, 16>(q, k, v, o, B, S, H, KV, st, causal, scale,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, H, KV, st, causal, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, KV, st, causal, scale,
                           stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16. strides: 12 element strides, (b, s, head)
// of q, k, v and o in turn. Returns cudaGetLastError() of the launch.
extern "C" int flash_attention_launch(int device, int dtype, int hd,
                                      const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KV, const long long* strides,
                                      int causal, float scale,
                                      cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0)
    return (int)launch_hd<float>(hd, q, k, v, o, B, S, H, KV, strides,
                                 causal, scale, stream);
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, H, KV,
                                         strides, causal, scale, stream);
  return (int)cudaErrorInvalidValue;
}
