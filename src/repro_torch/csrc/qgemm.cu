// Approximate int8 GEMMs: the tiled plane-0 kernel (exact / truncation
// multipliers, prefill-shaped) and the fused low-rank kernel with its
// stacked twin (any M).  The decode-shaped skinny kernel is in skinny.cu.
//
// ---------------------------------------------------------------------------
// repro_qgemm_plane0
// Replaces: src/repro/kernels/approx_qgemm.py, approx_qgemm_plane0
// (_plane0_kernel).  C (M, N) f32 = sum_k (A & mask_a)[m, k] *
// (B & mask_b)[k, n] with A (M, K) int8 row-major and B given K-major, as
// Bt (N, K) int8, accumulated in int32.
//
// Bound on the H100: bytes at the prefill shapes of the serving path
// (M = 128: the weight, K x N bytes, is read once and dominates; 0.3645 ms
// for the 154 GEMMs of one TinyLlama-1.1B prefill), operations at large M
// (the CNN im2col GEMMs).  At M = 128 a grid of M / BM x N / BN tiles is far
// short of the 132 SMs (16 blocks of 128 x 128 at N = 2048), and a block
// that streams its K slice one tile at a time waits on every load.  Design:
//   - 64 x 64 block tiles, four warps of 32 x 32, int8 tensor-core MMAs
//     (mma.sync m16n8k32 s8.s8.s32) fed by ldmatrix;
//   - both operands K-major, so tiles go from global to shared memory as
//     16-byte cp.async copies, 128 bytes of each row per stage, through a
//     ring of four stages: the MMAs on stage i overlap the copies of the
//     next three.  A K chunk that ends inside a stage zero-fills the rest;
//   - the truncation masks are ANDed into each 32-bit fragment register as
//     it is read from shared memory;
//   - split-K where the tile grid is short (kernels/qgemm.py plane0_splits:
//     at most half the SMs): split z sums its own K chunk in int32 into a
//     workspace slice, and a second small kernel adds the slices in split
//     order and converts once to f32.  int32 sums are exact in any order,
//     so the result is bit-exact whatever the split; f32 atomics would not
//     be (sums over K = 5632 reach 9.2e7 > 2^24).  With one split the block
//     writes f32 itself.
// Operands are padded by the wrapper: M, N and K multiples of 64.  Tile
// shapes from 64 x 64 to 128 x 128, K stages of 64 to 256 bytes and two to
// eight stages measured alike at the prefill shapes (within the spread
// between runs), so the smallest tile that fills the card was kept.
//
// ---------------------------------------------------------------------------
// repro_qgemm_skinny: see skinny.cu.
//
// ---------------------------------------------------------------------------
// repro_qgemm_fused
// Replaces: src/repro/kernels/approx_qgemm.py, approx_qgemm_fused
// (_fused_kernel + _correction_dots).  The low-rank GEMM at any M:
//   acc_0 = (A & mask_a) . (B & mask_b)
//   acc_r = U_r(A) . V_r(B), r = 1..R   (U_r(a) = fu[r-1][a & 0xFF], zero
//                                        at k >= k_valid; V_r likewise)
//   C = ((0 + 1 acc_0) + s_1 acc_1) + ...   (s_r = -s_r of the spec)
// with A (M, K) raw int8, the weight given K-major as Bt (N, K), R <= 8.
//
// Bound on the H100: operations, 2 M K N (R + 1) at the int8 tensor-core
// rate, once M K N is large (every im2col GEMM of the CNNs); bytes (the raw
// operands once, M K + K N + 4 M N) below that.  Besides the MMAs, every
// block maps its A tile through the tables once per plane: M K R (N / BN)
// byte lookups from shared memory, 5.3e9 in a VGG16 forward under a rank-5
// multiplier, and they set the pace.  Design:
//   - the weight's R + 1 planes are made once per call by a small kernel
//     (lowrank_b_planes_kernel) into a K-major (R + 1, N, K) workspace, so
//     the main kernel maps only A, and both MMA operands are K-major;
//   - 128 x 128 block tiles (two warpgroups of 64 rows), or 128 x 64 (two
//     blocks per SM) where that pads N less (the conv1 layers' N = 64);
//   - tiles arrive by TMA tensor copies (128-byte swizzle, 128 K bytes a
//     stage) into a ring of four stages, each completing on its mbarrier;
//     thread 0 issues them two stages ahead.  16-byte cp.async copies
//     could not feed the MMAs: the copy stream alone took longer than the
//     whole kernel does now (PERF.md, section 6);
//   - each warp loads its 16 rows of A with ldmatrix and maps them in
//     registers (plane 0 ANDed with mask_a; plane r through fu[r - 1];
//     bytes at k >= k_valid zeroed, since pad zeros map to tbl[0] != 0):
//     every A byte is mapped once per block and plane, and the mapped
//     fragment is the A operand of wgmma.mma_async m64n{128,64}k32 s8,
//     whose B the tensor cores read from the swizzled tile by descriptor;
//   - A registers are double-buffered, so one wgmma group stays in flight
//     while the next stage is mapped; one __syncthreads per stage frees
//     the buffer that TMA refills;
//   - planes are the outermost loop of a block (one int32 and one f32
//     accumulator per output); after plane p's last K tile its int32 sum
//     is flushed as out = __fadd_rn(out, __fmul_rn(s_p, (float)acc)), in
//     plane order, so no FMA contraction can change a bit against the
//     plain version.  A partial K sum is never flushed.
// The tables are one 256-byte copy per plane (2 KiB at rank 8).  Pad rows
// of M and pad columns of N map to garbage that the wrapper crops.  No
// split-K: at M = 128 the grid is N / 128 blocks.  Operands are padded by
// the wrapper: M a multiple of 128, K of 32, N of the tile width.
//
// ---------------------------------------------------------------------------
// repro_qgemm_stacked
// Replaces: src/repro/kernels/approx_qgemm.py, approx_qgemm_stacked
// (_stacked_kernel).  C = sum_p scales[p] * (A_p . B_p) over P <= 9 planes of
// pre-mapped (P, M, K) operand stacks and (P, N, K) K-major weight stacks
// (kernels/ops.py build_stacks maps the operands in PyTorch and pads after
// mapping, so pads are zero in every plane; the wrapper transposes the
// weight stack).  Bound on the H100: bytes of the P-fold stacks, or
// operations 2 M K N P, whichever is larger.  Design: the fused kernel with
// the map compiled out and plane p's A tile loaded from its own slice of
// the stack; the same flush, in the same order, so the two agree bit for
// bit.
#include "common.cuh"
#include "hopper.cuh"

#include <algorithm>
#include <type_traits>

namespace {

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ------------------------- plane 0 (redesigned) ---------------------------
constexpr int PL0_BM = 64, PL0_BN = 64;  // block tile: 2 x 2 warps of 32
constexpr int PL0_BK = 128;              // K bytes per stage
constexpr int PL0_KT = 64;               // K multiple the kernel takes
constexpr int PL0_STAGES = 4;
constexpr int PL0_THREADS = PL0_BM * PL0_BN / 32;
constexpr int PL0_LD = PL0_BK + 16;      // 16 bytes of pad: ldmatrix
                                         // conflict-free
constexpr int PL0_STAGE = (PL0_BM + PL0_BN) * PL0_LD;
constexpr int PL0_SMEM = PL0_STAGES * PL0_STAGE;

// Block (blockIdx.x, blockIdx.y) computes the 64 x 64 tile at (m0, n0) over
// K chunk blockIdx.z, one warp per 32 x 32 piece: f32 into C with one split,
// int32 into W's slice z otherwise.
__global__ void __launch_bounds__(PL0_THREADS)
plane0_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
              float* __restrict__ C, int* __restrict__ W, int M, int K, int N,
              int k_chunk, uint32_t mask_a, uint32_t mask_b) {
  constexpr int BM = PL0_BM, BN = PL0_BN, BK = PL0_BK, STAGES = PL0_STAGES;
  constexpr int THREADS = PL0_THREADS, STAGE = PL0_STAGE;
  extern __shared__ __align__(128) uint8_t smem[];  // [STAGES][STAGE]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / (BN / 32), wn = warp % (BN / 32);
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_len = min(K, k_begin + k_chunk) - k_begin;
  const int k_tiles = (k_len + BK - 1) / BK;
  const int8_t* a_src = A + (size_t)m0 * K + k_begin;
  const int8_t* b_src = Bt + (size_t)n0 * K + k_begin;

  // One stage: BM rows of A and BN rows of B, BK bytes each, as 16-byte
  // chunks spread over the threads; columns past the chunk are zero-filled.
  auto load = [&](int stage, int kt) {
    constexpr int CPR = BK / 16;         // chunks per row
    uint8_t* as = smem + stage * STAGE;
    uint8_t* bs = as + BM * PL0_LD;
    const int k0 = kt * BK;
#pragma unroll
    for (int c = tid; c < (BM + BN) * CPR; c += THREADS) {
      const int r = c / CPR, col = (c % CPR) * 16;
      const bool in = k0 + col < k_len;
      const int kc = in ? k0 + col : 0;
      if (r < BM) {
        repro_cp_async16(as + r * PL0_LD + col,
                         a_src + (size_t)r * K + kc, in);
      } else {
        repro_cp_async16(bs + (r - BM) * PL0_LD + col,
                         b_src + (size_t)(r - BM) * K + kc, in);
      }
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < k_tiles) load(st, st);
    repro_cp_async_commit();
  }
  // ldmatrix row addresses: A matrices (rows 0-7 | 8-15) x (bytes 0-15 |
  // 16-31) give a0..a3; B matrices (n tile j: bytes 0-15 | 16-31, then n
  // tile j + 1) give b[j][0..1], b[j+1][0..1].
  const int a_row = wm * 32 + (lane & 15), a_col = (lane >> 4) * 16;
  const int b_row = wn * 32 + ((lane >> 4) << 3) + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 16;
  for (int kt = 0; kt < k_tiles; ++kt) {
    repro_cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < k_tiles) load(next % STAGES, next);
    repro_cp_async_commit();
    const uint8_t* as = smem + (kt % STAGES) * STAGE;
    const uint8_t* bs = as + BM * PL0_LD;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldmatrix_x4(af[mi],
                    as + (a_row + mi * 16) * PL0_LD + ks * 32 + a_col);
#pragma unroll
        for (int e = 0; e < 4; ++e) af[mi][e] &= mask_a;
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + (b_row + nj * 16) * PL0_LD + ks * 32 + b_col);
        bf[2 * nj][0] = r[0] & mask_b;
        bf[2 * nj][1] = r[1] & mask_b;
        bf[2 * nj + 1][0] = r[2] & mask_b;
        bf[2 * nj + 1][1] = r[3] & mask_b;
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }

  int* w = W + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int row = m0 + wm * 32 + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + t * 2;
      const size_t i0 = (size_t)row * N + col, i1 = i0 + (size_t)8 * N;
      const int* c = acc[mi][ni];
      if (gridDim.z == 1) {
        *reinterpret_cast<float2*>(C + i0) =
            make_float2((float)c[0], (float)c[1]);
        *reinterpret_cast<float2*>(C + i1) =
            make_float2((float)c[2], (float)c[3]);
      } else {
        *reinterpret_cast<int2*>(w + i0) = make_int2(c[0], c[1]);
        *reinterpret_cast<int2*>(w + i1) = make_int2(c[2], c[3]);
      }
    }
  }
}

// C = float(sum over the split slices of W, in split order), four
// elements a thread.
__global__ void plane0_reduce_kernel(const int* __restrict__ W,
                                     float* __restrict__ C, size_t mn,
                                     int splits) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= mn) return;
  int4 s = *reinterpret_cast<const int4*>(W + i);
#pragma unroll 8
  for (int z = 1; z < splits; ++z) {
    const int4 v = *reinterpret_cast<const int4*>(W + (size_t)z * mn + i);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  *reinterpret_cast<float4*>(C + i) =
      make_float4((float)s.x, (float)s.y, (float)s.z, (float)s.w);
}

// ----------------------------- low rank: fused / stacked -------------------
constexpr int LR_MAX_RANK = 8;
constexpr int LR_BM = 128;            // block rows: two warpgroups of 64
constexpr int LR_BK = kTmaBoxK;       // K bytes per stage: one swizzle row
constexpr int LR_KT = 32;             // K multiple the kernels take
constexpr int LR_STAGES = 4;
constexpr int LR_THREADS = 256;
constexpr int LR_TABLES = LR_MAX_RANK * 256;

// A stage: the A tile [128][128] then the weight tile [BN][128], both as
// TMA writes them with the 128-byte swizzle (16-byte chunk c of row r at
// chunk c ^ (r & 7)), 1024-byte aligned; after the ring, the tables and
// one mbarrier per stage.
template <int BN>
struct LrLayout {
  static constexpr int A_BYTES = LR_BM * LR_BK;
  static constexpr int STAGE = A_BYTES + BN * LR_BK;
  static constexpr int SMEM = 1024 + LR_STAGES * STAGE + LR_TABLES +
                              8 * LR_STAGES;
  // the narrow tile's sums take half the registers: two blocks fit an SM
  static constexpr int MIN_BLOCKS = BN == 64 ? 2 : 1;
  static_assert(STAGE % 1024 == 0, "1024-byte aligned tiles");
};

// w with the bytes at columns col + j >= k_valid set to zero (byte j of a
// little-endian word is column col + j).
__device__ __forceinline__ uint32_t keep_below(uint32_t w, int col,
                                               int k_valid) {
  const int n = k_valid - col;
  if (n >= 4) return w;
  if (n <= 0) return 0u;
  return w & (0xFFFFFFFFu >> (8 * (4 - n)));
}

// The fused kernel's weight planes, once per call: Bt (N, K) K-major ->
// Bp (planes, N, K), plane 0 = Bt & mask_b, plane r = fv[r - 1][Bt & 0xFF].
// `chunks` counts 16-byte chunks of one plane.
__global__ void lowrank_b_planes_kernel(const int8_t* __restrict__ Bt,
                                        const int8_t* __restrict__ fv,
                                        int8_t* __restrict__ Bp,
                                        size_t chunks, int planes,
                                        uint32_t mask_b) {
  __shared__ int8_t tv[LR_TABLES];
  for (int i = threadIdx.x; i < (planes - 1) * 256; i += blockDim.x) {
    tv[i] = fv[i];
  }
  __syncthreads();
  const uint4* src = reinterpret_cast<const uint4*>(Bt);
  uint4* dst = reinterpret_cast<uint4*>(Bp);
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x; c < chunks;
       c += stride) {
    const uint4 v = src[c];
    dst[c] = make_uint4(v.x & mask_b, v.y & mask_b, v.z & mask_b,
                        v.w & mask_b);
    for (int p = 1; p < planes; ++p) {
      const int8_t* t = tv + (p - 1) * 256;
      dst[p * chunks + c] = make_uint4(map_bytes(v.x, t), map_bytes(v.y, t),
                                       map_bytes(v.z, t), map_bytes(v.w, t));
    }
  }
}

// acc (a warpgroup's 64 x N int32) += A (64 x 32 int8, the mma.m16n8k32
// fragment of each warp's 16 rows, in registers) x B (N x 32 int8, K-major
// in shared memory, by descriptor); scale_d 0 overwrites acc.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64],
                                            const uint32_t a[4],
                                            uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32],
                                            const uint32_t a[4],
                                            uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// Block blockIdx.x computes the 128 x BN tile at (m0, n0) over every plane;
// tm_b maps the planes' weights K-major, (planes N, K).  kMap (fused): tm_a
// maps one (M, K) matrix, loaded again for every plane; each thread maps
// its own A fragment in registers (plane 0 ANDed with mask_a, plane r >= 1
// through fu[r - 1], zero at k >= k_valid).  !kMap (stacked): tm_a maps a
// (planes M, K) stack of pre-mapped operands, used as it lands.
template <int BN, bool kMap>
__global__ void __launch_bounds__(LR_THREADS, LrLayout<BN>::MIN_BLOCKS)
lowrank_kernel(const __grid_constant__ CUtensorMap tm_a,
               const __grid_constant__ CUtensorMap tm_b,
               const int8_t* __restrict__ fu, const float* __restrict__ scales,
               float* __restrict__ C, int M, int K, int N, int planes,
               int k_valid, uint32_t mask_a) {
  using L = LrLayout<BN>;
  constexpr int BM = LR_BM, BK = LR_BK, STAGES = LR_STAGES;
  constexpr int STAGE = L::STAGE, STEPS = BK / 32, NACC = BN / 2;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int8_t* tbl = reinterpret_cast<int8_t*>(smem + STAGES * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(tbl + LR_TABLES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // N blocks fastest: the blocks that share an A tile run together.
  const int n_blocks = N / BN;
  const int m0 = (int)(blockIdx.x / n_blocks) * BM;
  const int n0 = (int)(blockIdx.x % n_blocks) * BN;
  const int k_tiles = (K + BK - 1) / BK;
  const int total = planes * k_tiles;  // stages over all planes

  if (kMap) {
    for (int i = tid; i < (planes - 1) * 256; i += LR_THREADS) tbl[i] = fu[i];
  }
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(full + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0's load stream: stage (lp, lkt) into buffer `buf`.
  int lp = 0, lkt = 0;
  auto load = [&](int buf) {
    uint8_t* as = smem + buf * STAGE;
    mbar_expect_tx(full + buf, STAGE);
    tma_load_2d(as, &tm_a, lkt * BK, m0 + (kMap ? 0 : lp * M), full + buf);
    tma_load_2d(as + L::A_BYTES, &tm_b, lkt * BK, lp * N + n0, full + buf);
    if (++lkt == k_tiles) {
      lkt = 0;
      ++lp;
    }
  };

  int acc[NACC];
  float out[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    acc[i] = 0;
    out[i] = 0.f;
  }
  uint32_t af[2][STEPS][4];  // A fragments, double-buffered by stage parity
  const int a_row = warp * 16 + (lane & 15), a_half = lane >> 4;
  const int row = m0 + warp * 16 + g;  // this thread's output rows (+ 8)
  int cp = 0, ckt = 0;                 // the compute stream's (plane, tile)

  // Stage it: A fragments into af[P] (mapped for plane cp), the
  // warpgroup's wgmmas on them and the weight tile, one group left in
  // flight; after a plane's last tile, its int32 sums are flushed.
  auto stage = [&](auto pc, int it) {
    constexpr int P = decltype(pc)::value;
    const int p = cp, kt = ckt;
    const uint8_t* as = smem + (it % STAGES) * STAGE;
    const uint8_t* bs = as + L::A_BYTES;
    const int8_t* tp = tbl + (p > 0 ? p - 1 : 0) * 256;
#pragma unroll
    for (int ks = 0; ks < STEPS; ++ks) {
      uint32_t* f = af[P][ks];
      const int ck = kt * BK + ks * 32;  // the K step's first column
      if (kMap && p > 0 && ck >= k_valid) {  // all pad: maps to zero
        f[0] = f[1] = f[2] = f[3] = 0u;
        continue;
      }
      ldmatrix_x4(f, as + a_row * BK +
                         (((ks * 2 + a_half) ^ (a_row & 7)) << 4));
      if (kMap && p > 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) f[e] = map_bytes(f[e], tp);
        if (ck + 32 > k_valid) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            f[e] = keep_below(f[e], ck + (e >> 1) * 16 + t * 4, k_valid);
          }
        }
      } else if (kMap) {
#pragma unroll
        for (int e = 0; e < 4; ++e) f[e] &= mask_a;
      }
    }
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < STEPS; ++ks) {
      const uint64_t db = swizzle128_desc(bs + ks * 32);
      const int scale_d = (kt == 0 && ks == 0) ? 0 : 1;
      if constexpr (BN == 128) {
        wgmma_s8_n128(acc, af[P][ks], db, scale_d);
      } else {
        wgmma_s8_n64(acc, af[P][ks], db, scale_d);
      }
    }
    wg_commit();
    if (++ckt < k_tiles) {
      wg_wait<1>();
      return;
    }
    ckt = 0;  // plane p's K sum is complete
    ++cp;
    wg_wait<0>();
    const float s = scales[p];
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      out[i] = __fadd_rn(out[i], __fmul_rn(s, (float)acc[i]));
    }
  };

  auto step = [&](auto pc, int it) {
    mbar_wait(full + it % STAGES, (it / STAGES) & 1);
    // this thread's reads of stage it - 2's buffer are done (its wgmmas
    // retired at the last wait): order them before the TMA that refills it
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && it + STAGES - 2 < total) load((it + STAGES - 2) % STAGES);
    stage(pc, it);
  };

  if (tid == 0) {
    for (int st = 0; st < STAGES - 2 && st < total; ++st) load(st);
  }
  for (int it = 0; it < total; it += 2) {
    step(std::integral_constant<int, 0>{}, it);
    if (it + 1 < total) step(std::integral_constant<int, 1>{}, it + 1);
  }
  wg_wait<0>();

  // warp w holds rows 16 w + g (+ 8); column block j of 8 in
  // acc[4 j .. 4 j + 3]
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + t * 2;
    *reinterpret_cast<float2*>(C + (size_t)row * N + col) =
        make_float2(out[4 * j], out[4 * j + 1]);
    *reinterpret_cast<float2*>(C + (size_t)(row + 8) * N + col) =
        make_float2(out[4 * j + 2], out[4 * j + 3]);
  }
}

// Whether the low-rank kernels take (m, k, n) at block width bn.
bool lowrank_shape_ok(int m, int k, int n, int bn) {
  if (bn != 64 && bn != 128) return false;
  if (m < LR_BM || n < bn || k < LR_KT || m % LR_BM || n % bn || k % LR_KT) {
    return false;
  }
  return (long long)(m / LR_BM) * (n / bn) <= 0x7FFFFFFFLL;
}

unsigned lowrank_blocks(int m, int n, int bn) {
  return (unsigned)((long long)(m / LR_BM) * (n / bn));
}

// Threads and blocks of lowrank_b_planes_kernel over an (n, k) weight.
constexpr int BP_THREADS = 256;
unsigned b_planes_blocks(int n, int k) {
  const size_t chunks = (size_t)n * k / 16;
  return (unsigned)std::min((chunks + BP_THREADS - 1) / BP_THREADS,
                            (size_t)132 * 16);
}

// Threads and blocks of plane0_reduce_kernel over an (m, n) output.
constexpr int RED_THREADS = 64;
unsigned reduce_blocks(int m, int n) {
  const size_t mn = (size_t)m * n;
  return (unsigned)((mn / 4 + RED_THREADS - 1) / RED_THREADS);
}

bool plane0_shape_ok(int m, int k, int n, int k_chunk) {
  return m >= 1 && n >= 1 && k >= 1 && m % PL0_BM == 0 && n % PL0_BN == 0 &&
         k % PL0_KT == 0 && k_chunk >= PL0_KT && k_chunk % PL0_KT == 0 &&
         m / PL0_BM <= 65535 && (k + k_chunk - 1) / k_chunk <= 65535;
}

// a: A (kMap) or the A stack; bp: the weight planes (planes, n, k).
template <int BN, bool kMap>
cudaError_t lowrank_launch(const void* a, const void* bp, const void* fu,
                           const void* scales, void* out, int m, int k, int n,
                           int planes, int k_valid, uint32_t mask_a,
                           cudaStream_t s) {
  CUtensorMap tm_a, tm_b;
  if (!tensor_map_2d(&tm_a, a, kMap ? m : planes * m, k, LR_BM) ||
      !tensor_map_2d(&tm_b, bp, planes * n, k, BN)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err =
      repro_smem_limit<lowrank_kernel<BN, kMap>>(LrLayout<BN>::SMEM);
  if (err != cudaSuccess) return err;
  lowrank_kernel<BN, kMap>
      <<<lowrank_blocks(m, n, BN), LR_THREADS, LrLayout<BN>::SMEM, s>>>(
      tm_a, tm_b, (const int8_t*)fu, (const float*)scales, (float*)out, m, k,
      n, planes, k_valid, mask_a);
  return cudaGetLastError();
}

}  // namespace

// Query kernels 1, 2, 4, 5, 6 (query.cu), with the arguments their C entry
// points take:
//   1 plane0_kernel            (m, k, n, k_chunk)
//   2 plane0_reduce_kernel     (m, n, splits)
//   4 lowrank_kernel<bn, true> (m, k, n, bn, rank)    the fused kernel
//   5 lowrank_b_planes_kernel  (n, k, rank)
//   6 lowrank_kernel<bn, false> (m, k, n, bn, planes) the stacked kernel
int repro_query_qgemm(int kernel, const int* a, long long* out) {
  const int bad = (int)cudaErrorInvalidValue;
  switch (kernel) {
    case 1:
      if (!plane0_shape_ok(a[0], a[1], a[2], a[3])) return bad;
      return repro_query_fill(
          (const void*)plane0_kernel, PL0_SMEM, PL0_SMEM, PL0_THREADS,
          dim3(a[2] / PL0_BN, a[0] / PL0_BM, (a[1] + a[3] - 1) / a[3]), out);
    case 2:
      if (a[0] < 1 || a[1] < 1 || a[2] < 2) return bad;
      return repro_query_fill((const void*)plane0_reduce_kernel, 0, 0,
                              RED_THREADS, dim3(reduce_blocks(a[0], a[1])),
                              out);
    case 4:
    case 6: {
      const int m = a[0], k = a[1], n = a[2], bn = a[3];
      const int planes = kernel == 4 ? a[4] + 1 : a[4];
      if (!lowrank_shape_ok(m, k, n, bn) || planes < 1 ||
          planes > LR_MAX_RANK + 1) {
        return bad;
      }
      const bool map = kernel == 4;
      const void* f =
          bn == 64 ? (map ? (const void*)lowrank_kernel<64, true>
                          : (const void*)lowrank_kernel<64, false>)
                   : (map ? (const void*)lowrank_kernel<128, true>
                          : (const void*)lowrank_kernel<128, false>);
      const long long smem =
          bn == 64 ? LrLayout<64>::SMEM : LrLayout<128>::SMEM;
      return repro_query_fill(f, smem, smem, LR_THREADS,
                              dim3(lowrank_blocks(m, n, bn)), out);
    }
    case 5:
      if (a[0] < 1 || a[1] < 1 || a[1] % 16 || a[2] < 0 ||
          a[2] > LR_MAX_RANK) {
        return bad;
      }
      return repro_query_fill((const void*)lowrank_b_planes_kernel, 0, 0,
                              BP_THREADS, dim3(b_planes_blocks(a[0], a[1])),
                              out);
    default:
      return bad;
  }
}

REPRO_API int repro_qgemm_plane0(const void* a, const void* bt, void* out,
                                 void* ws, int m, int k, int n, int mask_a,
                                 int mask_b, int k_chunk, void* stream) {
  if (!plane0_shape_ok(m, k, n, k_chunk)) return (int)cudaErrorInvalidValue;
  const int splits = (k + k_chunk - 1) / k_chunk;
  if (splits > 1 && !ws) return (int)cudaErrorInvalidValue;
  const cudaError_t err = repro_smem_limit<plane0_kernel>(PL0_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(n / PL0_BN, m / PL0_BM, splits);
  plane0_kernel<<<grid, PL0_THREADS, PL0_SMEM, s>>>(
      (const int8_t*)a, (const int8_t*)bt, (float*)out, (int*)ws, m, k, n,
      k_chunk, repro_word_mask(mask_a), repro_word_mask(mask_b));
  if (splits > 1) {
    // small blocks: a short grid (m n / 4 threads) still spreads its
    // splits-deep reads over many SMs
    plane0_reduce_kernel<<<reduce_blocks(m, n), RED_THREADS, 0, s>>>(
        (const int*)ws, (float*)out, (size_t)m * n, splits);
  }
  return (int)cudaGetLastError();
}

REPRO_API int repro_qgemm_fused(const void* a, const void* bt, const void* fu,
                                const void* fv, const void* scales,
                                void* bplanes, void* out, int m, int k, int n,
                                int bn, int k_valid, int rank, int mask_a,
                                int mask_b, void* stream) {
  if (!lowrank_shape_ok(m, k, n, bn) || rank < 0 || rank > LR_MAX_RANK ||
      k_valid < 1 || k_valid > k || !bplanes) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int planes = rank + 1;
  lowrank_b_planes_kernel<<<b_planes_blocks(n, k), BP_THREADS, 0, s>>>(
      (const int8_t*)bt, (const int8_t*)fv, (int8_t*)bplanes,
      (size_t)n * k / 16, planes, repro_word_mask(mask_b));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const uint32_t ma = repro_word_mask(mask_a);
  return (int)(bn == 64 ? lowrank_launch<64, true>(a, bplanes, fu, scales, out,
                                                   m, k, n, planes, k_valid,
                                                   ma, s)
                        : lowrank_launch<128, true>(a, bplanes, fu, scales,
                                                    out, m, k, n, planes,
                                                    k_valid, ma, s));
}

REPRO_API int repro_qgemm_stacked(const void* a, const void* bt,
                                  const void* scales, void* out, int planes,
                                  int m, int k, int n, int bn, void* stream) {
  if (!lowrank_shape_ok(m, k, n, bn) || planes < 1 ||
      planes > LR_MAX_RANK + 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bn == 64 ? lowrank_launch<64, false>(a, bt, nullptr, scales,
                                                    out, m, k, n, planes, k,
                                                    ~0u, s)
                        : lowrank_launch<128, false>(a, bt, nullptr, scales,
                                                     out, m, k, n, planes, k,
                                                     ~0u, s));
}
