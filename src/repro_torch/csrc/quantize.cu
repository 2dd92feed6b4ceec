// Fused per-row symmetric int8 quantization with the LSB-truncation mask.
//
// Replaces: src/repro/kernels/quantize.py, quantize_rows (_kernel), the
// Pallas TPU kernel that quantizes the activations before every
// approximate GEMM.
//
// Computes, per row of an (M, K) f32 matrix:
//   scale = max(absmax(row), 1e-8) * f32(1/127)
//   q     = clip(round_half_even(x / scale), -128, 127) as int8, AND mask
// and writes q (M, K) int8 and scale (M,) f32.  XLA compiles the
// reference's `/ 127` into that multiply; x / scale stays a true divide
// there and here.
//
// Bound on the H100: bytes.  It reads 4 bytes and writes 1 per element and
// does a handful of operations on each, far below the card's rate of
// operations per byte.  Design: one block per row, so the absmax is a block
// reduction (warp shuffles, then one shared-memory step) and needs no second
// launch; the second pass re-reads the row, which at K <= 5632 (22 KB) is
// still in L1/L2, so device memory sees each input byte about once.
//
// Bit-exact with the plain version and with compiled jnp: an IEEE divide
// for x / scale (__fdiv_rn, never the fast reciprocal), rintf for
// round-half-to-even, and the mask applied after rounding.  Build without
// --use_fast_math.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kInvInt8Max = 1.0f / 127.0f;  // f32(1/127), as XLA folds it

__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale_out, int k, int mask) {
  const float* row = x + (size_t)blockIdx.x * k;
  int8_t* qrow = q + (size_t)blockIdx.x * k;

  float amax = 0.f;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    amax = fmaxf(amax, fabsf(row[i]));
  }
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  __shared__ float red[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, red[w]);

  const float scale = __fmul_rn(fmaxf(amax, 1e-8f), kInvInt8Max);
  for (int i = threadIdx.x; i < k; i += kThreads) {
    float r = rintf(__fdiv_rn(row[i], scale));
    r = fminf(fmaxf(r, -128.f), 127.f);
    qrow[i] = (int8_t)((int)r & mask);
  }
  if (threadIdx.x == 0) scale_out[blockIdx.x] = scale;
}

}  // namespace

REPRO_API int repro_quantize_rows(const void* x, void* q, void* scale, int m,
                                  int k, int mask, void* stream) {
  if (m > 0 && k > 0) {
    quantize_rows_kernel<<<m, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (int8_t*)q, (float*)scale, k, mask);
  }
  return (int)cudaGetLastError();
}

REPRO_API const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
