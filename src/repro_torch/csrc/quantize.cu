// Fused per-row symmetric int8 quantization with the LSB-truncation mask.
//
// Replaces: src/repro/kernels/quantize.py, quantize_rows (_kernel), the
// Pallas TPU kernel that quantizes the activations before every
// approximate GEMM.
//
// Computes, per row of an (M, K) f32 matrix with row stride `ld`:
//   scale = max(absmax(row), 1e-8) * f32(1/127)
//   q     = clip(round_half_even(x / scale), -128, 127) as int8, AND mask
// and writes q (M, K) int8 (row stride K) and scale (M,) f32.  XLA
// compiles the reference's `/ 127` into that multiply; x / scale stays a
// true divide there and here.  Non-finite rows follow the reference: the
// absmax and the 1e-8 floor propagate NaN (jnp.max, jnp.maximum), a NaN
// quotient becomes code 0 (the reference's float-to-int8 cast), so a row
// holding a NaN gets scale NaN and codes 0, and a row holding +-inf gets
// scale inf and codes 0 (finite / inf = 0, inf / inf = NaN).
//
// Bound on the H100: bytes.  It reads 4 bytes and writes 1 per element and
// does a few dozen operations on each, below the card's operations per
// byte.  Design (the launch plan is quantize.launch_plan in Python):
//   * a group of `lanes` threads per row, 4 to 1024, chosen from M and K:
//     short rows share a warp, long rows span several warps, and few rows
//     spread over more lanes so that each thread's chain stays short;
//   * each thread loads all V of its units (a 16-byte float4, or 4 scalars)
//     before it reduces, so the row is read from device memory once, every
//     load in flight together, and the quantizing pass runs from registers;
//   * the absmax is a shuffle reduction within the group (one redux.sync
//     for a whole warp), plus one shared-memory step where a row spans
//     several warps;
//   * codes go out packed, 4 per 32-bit store, and one lane per row writes
//     the scale.
// Rows whose K, row stride or base is not 16-byte aligned take the scalar
// variant of the same kernel (VEC = false).  Rows longer than the register
// template (1024 lanes x 8 float4s, 32768 elements; 20480 in the scalar
// variant; beyond the repo's models) take a two-pass loop.
//
// Bit-exact with the plain version and with compiled jnp: an IEEE divide
// for x / scale (__fdiv_rn, never the fast reciprocal), rintf for
// round-half-to-even, and the mask applied after rounding.  Build without
// --use_fast_math.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kInvInt8Max = 1.0f / 127.0f;  // f32(1/127), as XLA folds it

// |v| as bits: for non-negative floats the unsigned order is the float
// order and every NaN lies above +inf, so an unsigned max propagates NaN as
// jnp.max does (fmaxf would drop it).
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// max(absmax, 1e-8) * f32(1/127); the comparison is false for NaN, which
// therefore passes through as jnp.maximum passes it.
__device__ __forceinline__ float row_scale(unsigned amax) {
  const float a = __uint_as_float(amax);
  return __fmul_rn(a < 1e-8f ? 1e-8f : a, kInvInt8Max);
}

// One code, before the mask: a NaN quotient is 0.  A zero element is code
// 0 whatever the scale (0 / finite or inf is 0, 0 / NaN casts to 0), so it
// divides the scale by itself instead: a zero dividend would send the
// divide down its slow path (ReLU outputs and im2col padding are half
// zeros), and a select, unlike a branch, leaves a thread's divides free to
// overlap.
__device__ __forceinline__ uint32_t code(float v, float scale) {
  const bool zero = v == 0.f;
  const float r = rintf(__fdiv_rn(zero ? scale : v, scale));
  const int c = zero || r != r ? 0 : (int)fminf(fmaxf(r, -128.f), 127.f);
  return (uint32_t)c & 0xffu;
}

// The max over a row's group of `lanes` threads (aligned, a power of two).
// Every thread of the block calls it: the shuffles take the whole warp and,
// for rows of more than a warp, the block meets at one barrier.
__device__ __forceinline__ unsigned group_max(unsigned v, int lanes) {
  if (lanes < 32) {
    for (int off = lanes >> 1; off > 0; off >>= 1) {
      v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
    }
    return v;
  }
  v = __reduce_max_sync(0xffffffffu, v);
  if (lanes > 32) {
    __shared__ unsigned red[kMaxThreads / 32];
    const int warp = threadIdx.x >> 5, warps = lanes >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    // the warp's lanes read the row's partials (each several times where
    // the row has fewer than 32 warps): one more warp max is the row's
    v = __reduce_max_sync(
        0xffffffffu,
        red[(warp & ~(warps - 1)) + (threadIdx.x & (warps - 1))]);
  }
  return v;
}

// The row in registers: thread `lane` of a row's group holds units
// j * lanes + lane, j < V; a unit is the float4 at element 4u (VEC) or the
// scalars j * lanes + lane, j < 4V (scalar variant).  Blocks hold
// blockDim.x / lanes rows.
template <int V, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale_out, int m, int k, int ld,
                     int lanes, uint32_t mask) {
  constexpr int E = 4 * V;
  const int lane = threadIdx.x & (lanes - 1);
  const int row = blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  const bool live = row < m;
  const float* xr = x + (size_t)(live ? row : 0) * ld;

  float v[E];
  if (VEC) {
    const int units = k >> 2;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int u = j * lanes + lane;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && u < units) t = __ldcs(reinterpret_cast<const float4*>(xr) + u);
      v[4 * j] = t.x;
      v[4 * j + 1] = t.y;
      v[4 * j + 2] = t.z;
      v[4 * j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = j * lanes + lane;
      v[j] = live && e < k ? __ldcs(xr + e) : 0.f;
    }
  }
  unsigned amax = 0;
#pragma unroll
  for (int i = 0; i < E; ++i) amax = max(amax, abs_bits(v[i]));
  amax = group_max(amax, lanes);
  if (!live) return;

  const float scale = row_scale(amax);
  int8_t* qr = q + (size_t)row * k;
  if (VEC) {
    const int units = k >> 2;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int u = j * lanes + lane;
      if (u < units) {
        const uint32_t w = code(v[4 * j], scale) |
                           code(v[4 * j + 1], scale) << 8 |
                           code(v[4 * j + 2], scale) << 16 |
                           code(v[4 * j + 3], scale) << 24;
        reinterpret_cast<uint32_t*>(qr)[u] = w & mask;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = j * lanes + lane;
      if (e < k) qr[e] = (int8_t)(code(v[j], scale) & mask);
    }
  }
  if (lane == 0) scale_out[row] = scale;
}

// Rows beyond the register plan: one block of kMaxThreads per row, the
// absmax over a strided loop, then a second pass that reads the row again.
template <bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
quantize_long_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                          float* __restrict__ scale_out, int k, int ld,
                          uint32_t mask) {
  const float* xr = x + (size_t)blockIdx.x * ld;
  int8_t* qr = q + (size_t)blockIdx.x * k;
  const int step = blockDim.x;
  unsigned amax = 0;
  if (VEC) {
    const float4* xv = reinterpret_cast<const float4*>(xr);
    for (int u = threadIdx.x; u < (k >> 2); u += step) {
      const float4 t = __ldg(xv + u);
      amax = max(max(amax, abs_bits(t.x)), max(abs_bits(t.y), max(
          abs_bits(t.z), abs_bits(t.w))));
    }
  } else {
    for (int e = threadIdx.x; e < k; e += step) {
      amax = max(amax, abs_bits(__ldg(xr + e)));
    }
  }
  const float scale = row_scale(group_max(amax, step));
  if (VEC) {
    const float4* xv = reinterpret_cast<const float4*>(xr);
    for (int u = threadIdx.x; u < (k >> 2); u += step) {
      const float4 t = __ldg(xv + u);
      const uint32_t w = code(t.x, scale) | code(t.y, scale) << 8 |
                         code(t.z, scale) << 16 | code(t.w, scale) << 24;
      reinterpret_cast<uint32_t*>(qr)[u] = w & mask;
    }
  } else {
    for (int e = threadIdx.x; e < k; e += step) {
      qr[e] = (int8_t)(code(__ldg(xr + e), scale) & mask);
    }
  }
  if (threadIdx.x == 0) scale_out[blockIdx.x] = scale;
}

// The register template: V float4s a lane in the 16-byte variant (at most
// 8), V x 4 scalars in the scalar one (at most 5: its per-element indexing
// needs more registers, and 1024-thread blocks leave 64 a thread).
constexpr int kMaxVecs = 8, kMaxScalarVecs = 5;

template <bool VEC, int V = 1>
cudaError_t launch(const float* x, int8_t* q, float* s, int m, int k, int ld,
                   int lanes, int vecs, int threads, int blocks,
                   uint32_t mask, cudaStream_t st) {
  if constexpr (V <= (VEC ? kMaxVecs : kMaxScalarVecs)) {
    if (vecs != V) {
      return launch<VEC, V + 1>(x, q, s, m, k, ld, lanes, vecs, threads,
                                blocks, mask, st);
    }
    quantize_rows_kernel<V, VEC><<<blocks, threads, 0, st>>>(
        x, q, s, m, k, ld, lanes, mask);
    return cudaSuccess;
  } else {
    return cudaErrorInvalidValue;
  }
}

// The register template's kernel for `vecs` units a lane (null past it).
template <bool VEC, int V = 1>
const void* rows_kernel(int vecs) {
  if constexpr (V <= (VEC ? kMaxVecs : kMaxScalarVecs)) {
    return vecs == V ? (const void*)quantize_rows_kernel<V, VEC>
                     : rows_kernel<VEC, V + 1>(vecs);
  } else {
    return nullptr;
  }
}

bool plan_ok(int lanes, int vecs, int threads) {
  return lanes >= 1 && lanes <= kMaxThreads && (lanes & (lanes - 1)) == 0 &&
         threads % lanes == 0 && threads <= kMaxThreads &&
         (vecs != 0 || lanes == threads);
}

}  // namespace

// Query kernel 0 (query.cu): args (m, k, vec, lanes, vecs, threads, blocks),
// the plan repro_quantize_rows takes.  No dynamic shared memory.
int repro_query_quantize(int kernel, const int* a, long long* out) {
  const int vec = a[2], lanes = a[3], vecs = a[4], threads = a[5],
            blocks = a[6];
  if (kernel != 0 || !plan_ok(lanes, vecs, threads) || blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const void* f =
      vecs == 0 ? (vec ? (const void*)quantize_long_rows_kernel<true>
                       : (const void*)quantize_long_rows_kernel<false>)
                : (vec ? rows_kernel<true>(vecs) : rows_kernel<false>(vecs));
  if (!f) return (int)cudaErrorInvalidValue;
  return repro_query_fill(f, 0, 0, threads, dim3((unsigned)blocks), out);
}

// x (row stride ld, 16-byte aligned with ld and k multiples of 4 when vec),
// q (M, K) contiguous, scale (M,); lanes, vecs (0: the two-pass loop),
// threads and blocks as quantize.launch_plan gives them.
REPRO_API int repro_quantize_rows(const void* x, void* q, void* scale, int m,
                                  int k, int ld, int vec, int lanes, int vecs,
                                  int threads, int blocks, int mask,
                                  void* stream) {
  if (m <= 0 || k <= 0) return (int)cudaGetLastError();
  if (!plan_ok(lanes, vecs, threads)) return (int)cudaErrorInvalidValue;
  const uint32_t word = repro_word_mask(mask);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  int8_t* qb = (int8_t*)q;
  float* sf = (float*)scale;
  cudaError_t err = cudaSuccess;
  if (vecs == 0 && vec) {
    quantize_long_rows_kernel<true><<<blocks, threads, 0, st>>>(
        xf, qb, sf, k, ld, word);
  } else if (vecs == 0) {
    quantize_long_rows_kernel<false><<<blocks, threads, 0, st>>>(
        xf, qb, sf, k, ld, word);
  } else if (vec) {
    err = launch<true>(xf, qb, sf, m, k, ld, lanes, vecs, threads, blocks,
                       word, st);
  } else {
    err = launch<false>(xf, qb, sf, m, k, ld, lanes, vecs, threads, blocks,
                        word, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

REPRO_API const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
