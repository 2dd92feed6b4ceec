// Hopper building blocks shared by the int8 GEMM kernels (qgemm.cu,
// skinny.cu): ldmatrix, the byte-table map, mbarriers, TMA tensor copies
// with their host-side tensor maps, and the warpgroup MMA fences.
#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// K bytes of one TMA box: one 128-byte swizzle row.
constexpr int kTmaBoxK = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const uint8_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Each byte of w through the 256-entry table tbl (indexed by the byte).
__device__ __forceinline__ uint32_t map_bytes(uint32_t w, const int8_t* tbl) {
  return (uint32_t)(uint8_t)tbl[w & 0xFF] |
         ((uint32_t)(uint8_t)tbl[(w >> 8) & 0xFF] << 8) |
         ((uint32_t)(uint8_t)tbl[(w >> 16) & 0xFF] << 16) |
         ((uint32_t)(uint8_t)tbl[w >> 24] << 24);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Order this thread's generic-proxy accesses to shared memory before the
// async-proxy ones (TMA, wgmma) that follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_u32(bar)) : "memory");
}
// Wait for the barrier's phase `phase`; trap after about ten seconds, so a
// fault in the pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(phase) : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}
// TMA: the box at (x = column, y = row) of tensor map `tm` into `dst`,
// completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* tm,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(tm)), "r"(x),
        "r"(y), "r"(smem_u32(bar))
      : "memory");
}
// wgmma descriptor of a 128-byte-swizzled K-major tile: 8-row groups 1024
// bytes apart (SBO); a K step's 32 bytes are added to the start address.
__device__ __forceinline__ uint64_t swizzle128_desc(const void* smem) {
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime (no link
// against libcuda).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) == cudaSuccess) {
      fn = (EncodeTiledFn)p;
    }
  }
  return fn;
}

// A tensor map over a row-major int8 (rows, cols) matrix, boxes of
// box_rows x 128 bytes, 128-byte swizzle, zeros past the edges.  `cols`
// must be a multiple of 16 (TMA's row stride).
bool tensor_map_2d(CUtensorMap* tm, const void* base, int rows, int cols,
                   int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)kTmaBoxK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
