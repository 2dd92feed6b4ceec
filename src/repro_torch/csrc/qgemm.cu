// Approximate int8 GEMMs: the tiled plane-0 kernel (exact / truncation
// multipliers, prefill-shaped) and the skinny kernel (decode-shaped, any
// rank of low-rank correction planes).
//
// ---------------------------------------------------------------------------
// repro_qgemm_plane0
// Replaces: src/repro/kernels/approx_qgemm.py, approx_qgemm_plane0
// (_plane0_kernel).  C (M, N) f32 = sum_k (A & mask_a)[m, k] * (B & mask_b)[k, n]
// with A (M, K) and B (K, N) int8 row-major, accumulated in int32.
//
// Bound on the H100: operations at large M; at the prefill shapes of the
// serving path (M = 128) a 128 x 128 tile grid gives only N / 128 blocks, so
// the grid, not the tensor cores, is what limits it.  Design: 128 x 128 x 32
// block tiles through shared memory, eight warps each owning a 64 x 32 piece,
// int8 tensor-core MMAs (mma.sync m16n8k32 s8.s8.s32).  B is (K, N) with N
// contiguous while the MMA wants K contiguous, so each thread reads a 4 x 4
// byte block of B and transposes it in registers before the shared-memory
// store.  The truncation masks are ANDed as the tiles are loaded.  The K loop
// runs inside the block, so the int32 accumulators never leave registers and
// the result is exact by construction.  Operands are padded by the wrapper:
// M, N multiples of 128, K a multiple of 32.
//
// ---------------------------------------------------------------------------
// repro_qgemm_skinny
// Replaces: src/repro/kernels/approx_qgemm.py, approx_qgemm_skinny
// (_skinny_kernel + _correction_dots).  For m <= 32 rows:
//   acc_0 = (A & mask_a) . (B & mask_b)
//   acc_r = U_r(A) . V_r(B), r = 1..R   (U_r(a) = fu[r-1][a & 0xFF], zero
//                                        past k_valid; V_r likewise with fv)
//   C = ((0 + s_0 acc_0) + s_1 acc_1) + ...    (s_0 = 1, s_r = -s_r)
//
// Bound on the H100: bytes.  The weight B (K x N int8) is read once per call
// and dominates every other term at m <= 32.  Design: a GEMV-style kernel,
// one block per 128 columns, per plane and per K split; each thread owns four
// columns and reads B four rows at a time as 32-bit words, transposes them in
// registers and runs __dp4a against the A words that the block stages in
// shared memory (all m rows at once, eight at a time in registers).  Split-K
// fills the 132 SMs when N / 128 is small; the partial sums meet through
// int32 atomics, which are exact in any order.  A second small kernel flushes
// the planes in order with __fmul_rn / __fadd_rn, so no FMA contraction can
// change a bit against the plain version.  Rank 0 passes no tables at all.
// Operands are padded by the wrapper: K a multiple of 4, N of 128.
//
// ---------------------------------------------------------------------------
// repro_qgemm_fused
// Replaces: src/repro/kernels/approx_qgemm.py, approx_qgemm_fused
// (_fused_kernel + _correction_dots).  The low-rank GEMM at any M:
//   acc_0 = (A & mask_a) . (B & mask_b)
//   acc_r = U_r(A) . V_r(B), r = 1..R   (U_r(a) = fu[r-1][a & 0xFF], zero
//                                        at k >= k_valid; V_r likewise)
//   C = ((0 + 1 acc_0) + s_1 acc_1) + ...   (s_r = -s_r of the spec)
// with A (M, K) and B (K, N) raw int8, R <= 8.
//
// Bound on the H100: operations, 2 M K N (R + 1) at the int8 tensor-core
// rate, once M K N is large (every im2col GEMM of the CNNs); bytes (the raw
// operands once, M K + K N + 4 M N) below that.  The TPU kernel keeps all
// R + 1 int32 accumulators of a 128 x 128 tile live at once; at rank 8 that
// is 576 KiB, more than an SM's register file.  Design: the plane-0 block
// tile (128 x 128 x 32, eight warps of 64 x 32, mma.sync m16n8k32) with
// the planes as the OUTERMOST loop of each block: one int32 accumulator and
// one f32 output accumulator live per thread.  The (R, 256) tables sit in
// shared memory, loaded once per block; plane r >= 1 maps each staged A
// and B word through them byte by byte before the shared-memory store, and
// zeroes mapped A bytes at k >= k_valid (pad zeros map to tbl[0] != 0).
// Pad rows of M and pad columns of N map to garbage that the wrapper crops.
// After each plane's K loop the int32 sum is flushed into the output as
// out = __fadd_rn(out, __fmul_rn(s_r, (float)acc)), in plane order, so no
// FMA contraction can change a bit against the plain version.  The cost of
// this design: the operands are re-read R + 1 times (from L2 where a tile
// row fits), and the loads are not pipelined.  No split-K.  Operands are
// padded by the wrapper: M, N multiples of 128, K a multiple of 32.
//
// ---------------------------------------------------------------------------
// repro_qgemm_stacked
// Replaces: src/repro/kernels/approx_qgemm.py, approx_qgemm_stacked
// (_stacked_kernel).  C = sum_p scales[p] * (A_p . B_p) over P <= 9 planes of
// pre-mapped (P, M, K) / (P, K, N) int8 stacks (kernels/ops.py build_stacks
// maps the operands in PyTorch and pads after mapping, so pads are zero in
// every plane).  Bound on the H100: bytes of the P-fold stacks, or
// operations 2 M K N P, whichever is larger.  Design: the same kernel as
// fused, with the table map and the K mask compiled out and plane p read
// from its own slice of the stacks; the same flush, in the same order, so
// the two kernels agree bit for bit.
#include "common.cuh"

namespace {

// ----------------------------- plane 0 -------------------------------------
constexpr int P0_BM = 128, P0_BN = 128, P0_BK = 32;
constexpr int P0_LD = 48;  // shared row stride in bytes: conflict-free frags
constexpr int P0_THREADS = 256;

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 32-deep K step of a block's 128 x 128 tile: the warp's 64 x 32 piece
// of As [m][k] x Bs [n][k] into its int32 accumulators.
__device__ __forceinline__ void tile_mma(const uint8_t* As, const uint8_t* Bs,
                                         int acc[4][4][4], int wm, int wn,
                                         int g, int t) {
  uint32_t af[4][4], bf[4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const uint8_t* p = As + (wm * 64 + mi * 16 + g) * P0_LD + t * 4;
    af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
    af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * P0_LD);
    af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
    af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * P0_LD + 16);
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const uint8_t* p = Bs + (wn * 32 + ni * 8 + g) * P0_LD + t * 4;
    bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
    bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
}

__global__ void __launch_bounds__(P0_THREADS)
plane0_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
              float* __restrict__ C, int M, int K, int N, uint32_t mask_a,
              uint32_t mask_b) {
  __shared__ __align__(16) uint8_t As[P0_BM * P0_LD];  // [m][k]
  __shared__ __align__(16) uint8_t Bs[P0_BN * P0_LD];  // [n][k]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64 x 32 each
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * P0_BM, n0 = blockIdx.x * P0_BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // A tile 128 x 32 bytes: 16 bytes per thread.
  const int a_row = tid >> 1, a_col = (tid & 1) * 16;
  // B tile 32 (k) x 128 (n): a 4 x 4 byte block per thread.
  const int b_k = (tid >> 5) * 4, b_n = (tid & 31) * 4;
  const int8_t* a_ptr = A + (size_t)(m0 + a_row) * K + a_col;
  const int8_t* b_ptr = B + (size_t)b_k * N + n0 + b_n;

  for (int k0 = 0; k0 < K; k0 += P0_BK) {
    uint4 av = *reinterpret_cast<const uint4*>(a_ptr + k0);
    av.x &= mask_a;
    av.y &= mask_a;
    av.z &= mask_a;
    av.w &= mask_a;
    *reinterpret_cast<uint4*>(As + a_row * P0_LD + a_col) = av;
    uint32_t r[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = *reinterpret_cast<const uint32_t*>(b_ptr + (size_t)(k0 + i) * N)
             & mask_b;
    }
    repro_transpose4x4(r, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<uint32_t*>(Bs + (b_n + j) * P0_LD + b_k) = c[j];
    }
    __syncthreads();

    tile_mma(As, Bs, acc, wm, wn, g, t);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int row = m0 + wm * 64 + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + t * 2;
      *reinterpret_cast<float2*>(C + (size_t)row * N + col) =
          make_float2((float)acc[mi][ni][0], (float)acc[mi][ni][1]);
      *reinterpret_cast<float2*>(C + (size_t)(row + 8) * N + col) =
          make_float2((float)acc[mi][ni][2], (float)acc[mi][ni][3]);
    }
  }
}

// ----------------------------- skinny --------------------------------------
constexpr int SK_THREADS = 256;
constexpr int SK_WARPS = SK_THREADS / 32;
constexpr int SK_BN = 128;  // 32 lanes x 4 columns
constexpr int SK_KT = 256;  // K rows staged in shared memory per pass
constexpr int SK_MT = 8;    // A rows held in registers per pass

__device__ __forceinline__ uint32_t map_bytes(uint32_t w, const int8_t* tbl) {
  return (uint32_t)(uint8_t)tbl[w & 0xFF] |
         ((uint32_t)(uint8_t)tbl[(w >> 8) & 0xFF] << 8) |
         ((uint32_t)(uint8_t)tbl[(w >> 16) & 0xFF] << 16) |
         ((uint32_t)(uint8_t)tbl[w >> 24] << 24);
}

__global__ void __launch_bounds__(SK_THREADS)
skinny_partial_kernel(const int8_t* __restrict__ A,
                      const int8_t* __restrict__ B,
                      const int8_t* __restrict__ fu,
                      const int8_t* __restrict__ fv, int* __restrict__ acc,
                      int M, int K, int N, int k_valid, uint32_t mask_a,
                      uint32_t mask_b, int k_chunk) {
  const int plane = blockIdx.z;
  const int n0 = blockIdx.x * SK_BN;
  const int kb = blockIdx.y * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  __shared__ uint32_t As[SK_MT][SK_KT / 4];
  __shared__ int red[SK_WARPS][SK_MT][SK_BN];
  __shared__ int8_t tu[256], tv[256];
  if (plane > 0) {
    tu[tid] = fu[(plane - 1) * 256 + tid];
    tv[tid] = fv[(plane - 1) * 256 + tid];
  }
  const int8_t* b_col = B + n0 + lane * 4;

  for (int m0 = 0; m0 < M; m0 += SK_MT) {
    int accr[SK_MT][4];
#pragma unroll
    for (int i = 0; i < SK_MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) accr[i][j] = 0;

    for (int kt = kb; kt < ke; kt += SK_KT) {
      const int kw = min(SK_KT, ke - kt) / 4;  // 32-bit words of K
      __syncthreads();
      for (int i = tid; i < SK_MT * (SK_KT / 4); i += SK_THREADS) {
        const int r = i / (SK_KT / 4), w = i % (SK_KT / 4);
        uint32_t word = 0;
        if (m0 + r < M && w < kw) {
          const int kk = kt + w * 4;
          word = *reinterpret_cast<const uint32_t*>(A + (size_t)(m0 + r) * K
                                                    + kk);
          if (plane == 0) {
            word &= mask_a;
          } else {
            word = map_bytes(word, tu);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (kk + j >= k_valid) word &= ~(0xFFu << (8 * j));
            }
          }
        }
        As[r][w] = word;
      }
      __syncthreads();
      for (int w = warp; w < kw; w += SK_WARPS) {
        const int8_t* p = b_col + (size_t)(kt + w * 4) * N;
        uint32_t r[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t v = *reinterpret_cast<const uint32_t*>(
              p + (size_t)i * N);
          r[i] = plane == 0 ? (v & mask_b) : map_bytes(v, tv);
        }
        repro_transpose4x4(r, c);
#pragma unroll
        for (int mi = 0; mi < SK_MT; ++mi) {
          const int aw = (int)As[mi][w];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            accr[mi][j] = __dp4a(aw, (int)c[j], accr[mi][j]);
          }
        }
      }
    }

#pragma unroll
    for (int mi = 0; mi < SK_MT; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][mi][lane * 4 + j] = accr[mi][j];
    __syncthreads();
    for (int i = tid; i < SK_MT * SK_BN; i += SK_THREADS) {
      const int mi = i / SK_BN, col = i % SK_BN;
      if (m0 + mi < M) {
        int s = 0;
#pragma unroll
        for (int w = 0; w < SK_WARPS; ++w) s += red[w][mi][col];
        atomicAdd(acc + ((size_t)plane * M + m0 + mi) * N + n0 + col, s);
      }
    }
  }
}

__global__ void skinny_flush_kernel(const int* __restrict__ acc,
                                    const float* __restrict__ scales,
                                    float* __restrict__ out, int mn,
                                    int planes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float o = 0.f;
  for (int r = 0; r < planes; ++r) {
    o = __fadd_rn(o, __fmul_rn(scales[r], (float)acc[(size_t)r * mn + i]));
  }
  out[i] = o;
}

// ----------------------------- low rank: fused / stacked -------------------
constexpr int LR_MAX_RANK = 8;

// w with the bytes at columns col + j >= k_valid set to zero (byte j of a
// little-endian word is column col + j).
__device__ __forceinline__ uint32_t keep_below(uint32_t w, int col,
                                               int k_valid) {
  const int n = k_valid - col;
  if (n >= 4) return w;
  if (n <= 0) return 0u;
  return w & (0xFFFFFFFFu >> (8 * (4 - n)));
}

template <bool kStacked>
__global__ void __launch_bounds__(P0_THREADS)
lowrank_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
               const int8_t* __restrict__ fu, const int8_t* __restrict__ fv,
               const float* __restrict__ scales, float* __restrict__ C,
               int M, int K, int N, int planes, int k_valid, uint32_t mask_a,
               uint32_t mask_b) {
  __shared__ __align__(16) uint8_t As[P0_BM * P0_LD];  // [m][k]
  __shared__ __align__(16) uint8_t Bs[P0_BN * P0_LD];  // [n][k]
  __shared__ int8_t tu[kStacked ? 1 : LR_MAX_RANK * 256];
  __shared__ int8_t tv[kStacked ? 1 : LR_MAX_RANK * 256];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64 x 32 each
  const int g = lane >> 2, t = lane & 3;
  // N blocks fastest: the blocks that share an A tile run together.
  const int n_blocks = N / P0_BN;
  const int m0 = (int)(blockIdx.x / n_blocks) * P0_BM;
  const int n0 = (int)(blockIdx.x % n_blocks) * P0_BN;

  if (!kStacked) {
    for (int i = tid; i < (planes - 1) * 256; i += P0_THREADS) {
      tu[i] = fu[i];
      tv[i] = fv[i];
    }
    __syncthreads();
  }

  const int a_row = tid >> 1, a_col = (tid & 1) * 16;
  const int b_k = (tid >> 5) * 4, b_n = (tid & 31) * 4;

  float out[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[i][j][e] = 0.f;

  for (int p = 0; p < planes; ++p) {
    const size_t a_off = kStacked ? (size_t)p * M * K : 0;
    const size_t b_off = kStacked ? (size_t)p * K * N : 0;
    const int8_t* a_ptr = A + a_off + (size_t)(m0 + a_row) * K + a_col;
    const int8_t* b_ptr = B + b_off + (size_t)b_k * N + n0 + b_n;
    const int8_t* ta = tu + (kStacked || p == 0 ? 0 : (p - 1) * 256);
    const int8_t* tb = tv + (kStacked || p == 0 ? 0 : (p - 1) * 256);

    int acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    for (int k0 = 0; k0 < K; k0 += P0_BK) {
      uint4 av = *reinterpret_cast<const uint4*>(a_ptr + k0);
      uint32_t r[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        r[i] = *reinterpret_cast<const uint32_t*>(b_ptr + (size_t)(k0 + i) * N);
      }
      if (!kStacked) {
        if (p == 0) {
          av.x &= mask_a;
          av.y &= mask_a;
          av.z &= mask_a;
          av.w &= mask_a;
#pragma unroll
          for (int i = 0; i < 4; ++i) r[i] &= mask_b;
        } else {
          av.x = map_bytes(av.x, ta);
          av.y = map_bytes(av.y, ta);
          av.z = map_bytes(av.z, ta);
          av.w = map_bytes(av.w, ta);
          const int kc = k0 + a_col;
          if (kc + 16 > k_valid) {
            av.x = keep_below(av.x, kc, k_valid);
            av.y = keep_below(av.y, kc + 4, k_valid);
            av.z = keep_below(av.z, kc + 8, k_valid);
            av.w = keep_below(av.w, kc + 12, k_valid);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) r[i] = map_bytes(r[i], tb);
        }
      }
      *reinterpret_cast<uint4*>(As + a_row * P0_LD + a_col) = av;
      repro_transpose4x4(r, c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<uint32_t*>(Bs + (b_n + j) * P0_LD + b_k) = c[j];
      }
      __syncthreads();
      tile_mma(As, Bs, acc, wm, wn, g, t);
      __syncthreads();
    }

    const float s = scales[p];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          out[i][j][e] = __fadd_rn(out[i][j][e],
                                   __fmul_rn(s, (float)acc[i][j][e]));
        }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int row = m0 + wm * 64 + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + t * 2;
      *reinterpret_cast<float2*>(C + (size_t)row * N + col) =
          make_float2(out[mi][ni][0], out[mi][ni][1]);
      *reinterpret_cast<float2*>(C + (size_t)(row + 8) * N + col) =
          make_float2(out[mi][ni][2], out[mi][ni][3]);
    }
  }
}

// Blocks of the low-rank kernels' grid, or 0 when the shape is refused.
long long lowrank_blocks(int m, int k, int n) {
  if (m < P0_BM || n < P0_BN || k < P0_BK || m % P0_BM || n % P0_BN ||
      k % P0_BK) {
    return 0;
  }
  const long long blocks = (long long)(m / P0_BM) * (n / P0_BN);
  return blocks > 0x7FFFFFFFLL ? 0 : blocks;
}

}  // namespace

REPRO_API int repro_qgemm_plane0(const void* a, const void* b, void* out,
                                 int m, int k, int n, int mask_a, int mask_b,
                                 void* stream) {
  if (m % P0_BM || n % P0_BN || k % P0_BK) return (int)cudaErrorInvalidValue;
  dim3 grid(n / P0_BN, m / P0_BM);
  plane0_kernel<<<grid, P0_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, (float*)out, m, k, n,
      repro_word_mask(mask_a), repro_word_mask(mask_b));
  return (int)cudaGetLastError();
}

REPRO_API int repro_qgemm_skinny(const void* a, const void* b, const void* fu,
                                 const void* fv, const void* scales, void* acc,
                                 void* out, int m, int k, int n, int k_valid,
                                 int rank, int mask_a, int mask_b, int splits,
                                 void* stream) {
  if (m < 1 || m > 32 || n % SK_BN || k % 4 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int planes = rank + 1;
  const size_t mn = (size_t)m * n;
  cudaMemsetAsync(acc, 0, planes * mn * sizeof(int), s);
  int k_chunk = (k + splits - 1) / splits;
  k_chunk = (k_chunk + 31) / 32 * 32;
  dim3 grid(n / SK_BN, (k + k_chunk - 1) / k_chunk, planes);
  skinny_partial_kernel<<<grid, SK_THREADS, 0, s>>>(
      (const int8_t*)a, (const int8_t*)b, (const int8_t*)fu,
      (const int8_t*)fv, (int*)acc, m, k, n, k_valid,
      repro_word_mask(mask_a), repro_word_mask(mask_b), k_chunk);
  const int threads = 256;
  skinny_flush_kernel<<<(unsigned)((mn + threads - 1) / threads), threads, 0,
                        s>>>((const int*)acc, (const float*)scales,
                             (float*)out, (int)mn, planes);
  return (int)cudaGetLastError();
}

REPRO_API int repro_qgemm_fused(const void* a, const void* b, const void* fu,
                                const void* fv, const void* scales, void* out,
                                int m, int k, int n, int k_valid, int rank,
                                int mask_a, int mask_b, void* stream) {
  const long long blocks = lowrank_blocks(m, k, n);
  if (!blocks || rank < 0 || rank > LR_MAX_RANK || k_valid < 1 ||
      k_valid > k) {
    return (int)cudaErrorInvalidValue;
  }
  lowrank_kernel<false><<<(unsigned)blocks, P0_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, (const int8_t*)fu,
      (const int8_t*)fv, (const float*)scales, (float*)out, m, k, n,
      rank + 1, k_valid, repro_word_mask(mask_a), repro_word_mask(mask_b));
  return (int)cudaGetLastError();
}

REPRO_API int repro_qgemm_stacked(const void* a, const void* b,
                                  const void* scales, void* out, int planes,
                                  int m, int k, int n, void* stream) {
  const long long blocks = lowrank_blocks(m, k, n);
  if (!blocks || planes < 1 || planes > LR_MAX_RANK + 1) {
    return (int)cudaErrorInvalidValue;
  }
  lowrank_kernel<true><<<(unsigned)blocks, P0_THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, nullptr, nullptr,
      (const float*)scales, (float*)out, m, k, n, planes, k, ~0u, ~0u);
  return (int)cudaGetLastError();
}
