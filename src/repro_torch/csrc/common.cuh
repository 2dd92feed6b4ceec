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

// 4x4 byte transpose: r[i] holds row i (four columns); on return c[j] holds
// column j (four rows), byte i of c[j] = byte j of r[i].
__device__ __forceinline__ void repro_transpose4x4(const uint32_t r[4],
                                                   uint32_t c[4]) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}
