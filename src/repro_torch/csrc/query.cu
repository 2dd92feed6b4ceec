// The host-only query of the kernel library: for a kernel variant and the
// arguments its C entry point takes, what its launcher would request (the
// dynamic shared memory, the opt-in limit it sets, the block and the grid)
// and what the compiled kernel holds (cudaFuncGetAttributes: static shared
// memory, registers, the largest block).  It launches nothing, so a checker
// (repro_torch/analysis/contracts.py) can hold the Python model of every
// variant (kernels/approx_qgemm.py) to the library without running a GEMM.
//
// Kernel ids (args in brackets; each file's repro_query_* checks them as its
// entry point does):
//   0 quantize_rows      (m, k, vec, lanes, vecs, threads, blocks)
//   1 plane0             (m, k, n, k_chunk)
//   2 plane0 reduce      (m, n, splits)
//   3 skinny             (m, k, n, rank, splits, gran)
//   4 fused              (m, k, n, bn, rank)
//   5 fused weight planes (n, k, rank)
//   6 stacked            (m, k, n, bn, planes)
//   7 flash_attention    (bh, sq, skv, d, is_bf16)
//  -1 the process's first-use cudaFuncSetAttribute calls, in out[0]
#include "common.cuh"

REPRO_API int repro_kernel_query(int kernel, const int* args, long long* out) {
  if (!out) return (int)cudaErrorInvalidValue;
  if (kernel == -1) {
    out[0] = repro_smem_attr_calls.load();
    return 0;
  }
  if (!args) return (int)cudaErrorInvalidValue;
  switch (kernel) {
    case 0: return repro_query_quantize(kernel, args, out);
    case 1: case 2: case 4: case 5: case 6:
      return repro_query_qgemm(kernel, args, out);
    case 3: return repro_query_skinny(kernel, args, out);
    case 7: return repro_query_flash(kernel, args, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
