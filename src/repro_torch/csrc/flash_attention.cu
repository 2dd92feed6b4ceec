// Online-softmax (flash) attention on (bh, s, d) tensors, f32 or bf16 in,
// f32 arithmetic, output in the input type.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (_kernel),
// the Pallas TPU kernel of the prefill attention (impl="flash").
//
// Computes O = softmax(Q K^T / sqrt(d)) V per head-batch, causal by global
// index (q_i sees kv_j for j <= i) when asked; kv tiles wholly above the
// diagonal are skipped.  Masked scores take -1e30 as in the reference.
//
// Bound on the H100: at the serving shapes (s = 128, d = 64) the work is a
// few MFLOP per call and the bytes a few MB, so launch latency and the
// memory of Q, K, V bound it.  The kernel runs in plain f32 FMAs (no TF32:
// the f32 contract is 2e-6).  Design: one block of four warps per 16 query
// rows and head-batch; the block stages 32 kv rows of K and V at a time in
// shared memory (rows padded to d + 1 floats, so lane j reading row j is
// conflict-free); lane j scores kv row j, the warp reduces the running max
// and denominator with shuffles, and each lane keeps d / 32 output columns
// of its warp's four rows in registers across the whole kv loop.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int FA_WARPS = 4;
constexpr int FA_ROWS = 4;                   // query rows per warp
constexpr int FA_BQ = FA_WARPS * FA_ROWS;    // query rows per block
constexpr int FA_KV = 32;                    // kv rows per tile: one per lane
constexpr float FA_NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// NC = d / 32 output columns per lane.
template <typename T, int NC>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_kernel(const T* __restrict__ Q, const T* __restrict__ K,
             const T* __restrict__ V, T* __restrict__ O, int sq, int skv,
             int causal, float scale) {
  constexpr int D = NC * 32;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                  // [FA_KV][LD]
  float* Vs = Ks + FA_KV * LD;       // [FA_KV][LD]
  float* Qs = Vs + FA_KV * LD;       // [FA_BQ][D]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t base = (size_t)blockIdx.y;
  const T* Qb = Q + base * sq * D;
  const T* Kb = K + base * skv * D;
  const T* Vb = V + base * skv * D;
  T* Ob = O + base * sq * D;
  const int q0 = blockIdx.x * FA_BQ;

  for (int i = tid; i < FA_BQ * D; i += FA_WARPS * 32) {
    const int r = i / D;
    Qs[i] = (q0 + r < sq) ? to_f32(Qb[(size_t)q0 * D + i]) : 0.f;
  }

  float m_run[FA_ROWS], l_run[FA_ROWS], acc[FA_ROWS][NC];
#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    m_run[r] = FA_NEG_INF;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  int n_tiles = (skv + FA_KV - 1) / FA_KV;
  if (causal) n_tiles = min(n_tiles, (q0 + FA_BQ - 1) / FA_KV + 1);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * FA_KV;
    __syncthreads();
    for (int i = tid; i < FA_KV * D; i += FA_WARPS * 32) {
      const int r = i / D, c = i % D;
      const bool in = kv0 + r < skv;
      Ks[r * LD + c] = in ? to_f32(Kb[(size_t)kv0 * D + i]) : 0.f;
      Vs[r * LD + c] = in ? to_f32(Vb[(size_t)kv0 * D + i]) : 0.f;
    }
    __syncthreads();

    const int kvj = kv0 + lane;
#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r) {
      const int qr = warp * FA_ROWS + r;
      const int qi = q0 + qr;
      if (qi >= sq) break;  // warp-uniform
      const float* qrow = Qs + qr * D;
      const float* krow = Ks + lane * LD;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s = fmaf(qrow[c], krow[c], s);
      s *= scale;
      const bool in_range = kvj < skv;
      if (causal && kvj > qi) s = FA_NEG_INF;
      if (!in_range) s = FA_NEG_INF;
      const float m_new = fmaxf(m_run[r], warp_max(s));
      const float p = in_range ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_run[r] - m_new);
      l_run[r] = alpha * l_run[r] + warp_sum(p);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float a = acc[r][c] * alpha;
        const float* vcol = Vs + c * 32 + lane;
#pragma unroll 8
        for (int j = 0; j < FA_KV; ++j) {
          a = fmaf(__shfl_sync(0xffffffffu, p, j), vcol[j * LD], a);
        }
        acc[r][c] = a;
      }
      m_run[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    const int qi = q0 + warp * FA_ROWS + r;
    if (qi >= sq) break;
    const float l = fmaxf(l_run[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(Ob + (size_t)qi * D + c * 32 + lane, acc[r][c] / l);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int sq, int skv, int causal, float scale,
                   cudaStream_t stream) {
  constexpr int D = NC * 32;
  const size_t smem = (size_t)(2 * FA_KV * (D + 1) + FA_BQ * D) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + FA_BQ - 1) / FA_BQ, bh);
  flash_kernel<T, NC><<<grid, FA_WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int bh, int sq, int skv, int d, int causal,
                       float scale, cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 1>(q, k, v, o, bh, sq, skv, causal, scale, s);
    case 64: return launch<T, 2>(q, k, v, o, bh, sq, skv, causal, scale, s);
    case 128: return launch<T, 4>(q, k, v, o, bh, sq, skv, causal, scale, s);
    case 256: return launch<T, 8>(q, k, v, o, bh, sq, skv, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

REPRO_API int repro_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int bh, int sq,
                                    int skv, int d, int causal, int is_bf16,
                                    float scale, void* stream) {
  if (bh < 1 || sq < 1 || skv < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, o, bh, sq, skv, d, causal,
                                          scale, s)
              : dispatch_d<float>(q, k, v, o, bh, sq, skv, d, causal, scale,
                                  s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
