// Shared helpers of the kernel library (see kernels/build.py for how it is
// built and bound).  Every C entry point launches on the stream it is given
// and returns cudaGetLastError(), so a launch that CUDA refuses surfaces in
// the Python wrapper instead of passing silently.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#define REPRO_API extern "C" __attribute__((visibility("default")))

// One byte mask replicated into the four bytes of a 32-bit word: the signed
// LSB-truncation mask of approx_qgemm.signed_trunc_mask (-1 = no truncation).
static inline uint32_t repro_word_mask(int mask) {
  return 0x01010101u * (uint32_t)(uint8_t)mask;
}

// 16-byte asynchronous copy global -> shared (cp.async, L1 bypassed).  With
// `valid` false nothing is read and the 16 shared bytes are zero-filled.
__device__ __forceinline__ void repro_cp_async16(void* smem, const void* gmem,
                                                 bool valid = true) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void repro_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `N` committed copy groups of this thread are pending.
template <int N>
__device__ __forceinline__ void repro_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cudaFuncSetAttribute calls `repro_smem_limit` has made in this process:
// first-use work, which the query (query.cu) reports so that a warm step
// can be told from a cold one.
inline std::atomic<long long> repro_smem_attr_calls{0};

// Raise `Kernel`'s dynamic shared-memory limit to `bytes`, once per device
// (the attribute outlives the launch; racing threads setting it twice is
// harmless).
template <auto Kernel>
cudaError_t repro_smem_limit(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  repro_smem_attr_calls.fetch_add(1);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// ----------------------------- the host-only query --------------------------
// One record per kernel variant and arguments (query.cu): what its launcher
// would request, and what the compiled kernel holds.  Nothing is launched.
enum ReproQueryField {
  RQ_DYN_SMEM,     // dynamic shared memory the launch requests (bytes)
  RQ_SMEM_LIMIT,   // the opt-in limit repro_smem_limit sets (0: none)
  RQ_THREADS,      // threads per block of the launch
  RQ_GRID_X, RQ_GRID_Y, RQ_GRID_Z,
  RQ_STATIC_SMEM,  // cudaFuncAttributes.sharedSizeBytes
  RQ_REGS,         // cudaFuncAttributes.numRegs
  RQ_MAX_THREADS,  // cudaFuncAttributes.maxThreadsPerBlock
  RQ_ATTR_DYN,     // cudaFuncAttributes.maxDynamicSharedSizeBytes now
  RQ_LOCAL,        // cudaFuncAttributes.localSizeBytes (spills)
  RQ_FIELDS
};

// Fill `out` for one launch of `func`.
static inline int repro_query_fill(const void* func, long long dyn,
                                   long long limit, int threads, dim3 grid,
                                   long long* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, func);
  if (err != cudaSuccess) return (int)err;
  out[RQ_DYN_SMEM] = dyn;
  out[RQ_SMEM_LIMIT] = limit;
  out[RQ_THREADS] = threads;
  out[RQ_GRID_X] = grid.x;
  out[RQ_GRID_Y] = grid.y;
  out[RQ_GRID_Z] = grid.z;
  out[RQ_STATIC_SMEM] = (long long)a.sharedSizeBytes;
  out[RQ_REGS] = a.numRegs;
  out[RQ_MAX_THREADS] = a.maxThreadsPerBlock;
  out[RQ_ATTR_DYN] = a.maxDynamicSharedSizeBytes;
  out[RQ_LOCAL] = (long long)a.localSizeBytes;
  return 0;
}

// Each kernel file answers for its own variants (ids in query.cu).
int repro_query_quantize(int kernel, const int* args, long long* out);
int repro_query_qgemm(int kernel, const int* args, long long* out);
int repro_query_skinny(int kernel, const int* args, long long* out);
int repro_query_flash(int kernel, const int* args, long long* out);
