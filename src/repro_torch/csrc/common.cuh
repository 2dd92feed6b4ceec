// Shared helpers of the kernel library (see kernels/build.py for how it is
// built and bound).  Every C entry point launches on the stream it is given
// and returns cudaGetLastError(), so a launch that CUDA refuses surfaces in
// the Python wrapper instead of passing silently.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}
