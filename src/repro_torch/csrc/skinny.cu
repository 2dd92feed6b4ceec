// repro_qgemm_skinny
// Replaces: src/repro/kernels/approx_qgemm.py, approx_qgemm_skinny
// (_skinny_kernel + _correction_dots).  For m <= 32 rows:
//   acc_0 = (A & mask_a) . (B & mask_b)
//   acc_r = U_r(A) . V_r(B), r = 1..R   (U_r(a) = fu[r-1][a & 0xFF], zero
//                                        at k >= k_valid; V_r likewise)
//   C = ((0 + s_0 acc_0) + s_1 acc_1) + ...    (s_0 = 1, s_r = -s_r)
// with A (m, K) int8 row-major and the weight given K-major, as Bt (N, K).
//
// Bound on the H100: bytes.  The weight (K x N int8) is read once per call
// and dominates every other term at m <= 32 (0.3113 ms for the 155 GEMMs of
// a TinyLlama-1.1B decode step).  Design:
//   - A and B swap roles: 64 of the weight's output columns fill the MMA's
//     M side (one warpgroup), the m activation rows, zero-padded to 8 or 32
//     in shared memory only, its N side: wgmma m64n8k32 / m64n32k32 s8;
//   - the weight streams by TMA (64 x 128-byte boxes, 128-byte swizzle)
//     through a ring of four 8 KiB stages, each with a full and an empty
//     mbarrier; a producer warp keeps 32 KiB of weight in flight per block;
//   - every plane from one read: each consumer warp loads its 16 rows of a
//     stage into registers with ldmatrix and releases the stage at once;
//     plane 0 is the fragment ANDed with mask_b, plane r the fragment mapped
//     through fv[r - 1] (a table in shared memory), each the register A of
//     its plane's wgmma, one group in flight while the next plane maps;
//   - the activations' planes (plane 0 ANDed with mask_a, plane r mapped
//     through fu[r - 1] and zeroed at k >= k_valid, since pad zeros map to
//     tbl[0] != 0; every plane zeroed outside the block's K range and past
//     row m) are built once per block in shared memory, in the swizzled
//     layout wgmma reads by descriptor; where they do not fit the budget,
//     once per window of K boxes;
//   - one launch per call: K splits until the grid covers the SMs
//     (kernels/qgemm.py skinny_splits); each split adds its exact int32
//     plane sums into a workspace with int32 atomics (exact in any order),
//     and a per-tile arrival counter (an acq_rel atomic add) lets the last
//     block of each tile read the totals, zero them, flush the planes
//     in plane order with __fmul_rn / __fadd_rn (no FMA contraction can
//     change a bit against the plain version) and reset the counter to 0
//     for the next call.  Atomic adds, not per-split slices that the last
//     block sums: a slice per split cost the last block one L2 round trip
//     per split (up to 33 at the decode shapes; PERF.md, section 6).  With one
//     split the block flushes from its registers.  The workspace and the
//     counters belong to the device (kernels/qgemm.py), so a call allocates
//     only its output and never syncs the host.
// Rank 0 passes no tables and no scales (s_0 = 1).  K must be a multiple of
// 16 (TMA's row stride); N and m are not padded: TMA fills zeros past the
// weight's edges and the flush stores only n < N, r < m.
#include "common.cuh"
#include "hopper.cuh"

#include <algorithm>

namespace {

constexpr int SK_BM = 64;                      // weight rows (outputs) a block
constexpr int SK_BK = kTmaBoxK;                // K bytes a stage
constexpr int SK_STAGES = 4;
constexpr int SK_STAGE = SK_BM * SK_BK;        // 8 KiB
constexpr int SK_CONSUMERS = 128;              // one warpgroup
constexpr int SK_THREADS = SK_CONSUMERS + 32;  // and the producer warp
constexpr int SK_MAX_RANK = 8;
constexpr int SK_ACT_BUDGET = 48 * 1024;       // activation planes, bytes

// Dynamic shared memory of a block: 1024-byte alignment slack, the ring,
// `win` K boxes of activation planes (each plane's box MP x 128 bytes),
// the fu and fv tables, 2 x STAGES mbarriers and the last-block flag.
constexpr int sk_smem(int planes, int mp, int win) {
  return 1024 + SK_STAGES * SK_STAGE + planes * win * mp * SK_BK +
         2 * (planes - 1) * 256 + 2 * SK_STAGES * 8 + 16;
}
constexpr int SK_SMEM_MAX =
    1024 + SK_STAGES * SK_STAGE + SK_ACT_BUDGET + 2 * SK_MAX_RANK * 256 +
    2 * SK_STAGES * 8 + 16;

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(SK_CONSUMERS) : "memory");
}

// The bytes of the word at columns col .. col + 3 that lie in [lo, hi).
__device__ __forceinline__ uint32_t bytes_in(int col, int lo, int hi) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (col + i >= lo && col + i < hi) m |= 0xFFu << (8 * i);
  }
  return m;
}

// d (64 x 8 NP int32) += A (64 x 32, each warp's 16 rows as the
// mma.m16n8k32 A fragment in registers) x B (8 NP x 32, K-major in shared
// memory, by descriptor).
template <int NP>
__device__ __forceinline__ void wgmma_s8(int (&d)[4 * NP], const uint32_t a[4],
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_s8<1>(int (&d)[4], const uint32_t a[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<4>(int (&d)[16], const uint32_t a[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Block (blockIdx.x, blockIdx.y) computes output columns [64 x, 64 x + 64)
// of every plane over K split y.  Threads 0-127 (one warpgroup) consume,
// warp 4 produces.  MP = 8 NP activation rows in the MMA; PLANES = R + 1.
template <int NP, int PLANES>
__global__ void __launch_bounds__(SK_THREADS)
skinny_kernel(const __grid_constant__ CUtensorMap tm_w,
              const int8_t* __restrict__ A, const int8_t* __restrict__ fu,
              const int8_t* __restrict__ fv, const float* __restrict__ scales,
              int* __restrict__ ws, int* __restrict__ counters,
              float* __restrict__ C, int M, int K, int N, int k_valid,
              uint32_t mask_a, uint32_t mask_b, int gran, int win) {
  constexpr int MP = 8 * NP, NACC = 4 * NP, R = PLANES - 1;
  constexpr int ACT_TILE = MP * SK_BK;  // one plane's activations, one box
  // activation loads in flight a thread: more where registers are free
  constexpr int BATCH =
      NP == 1 ? (PLANES <= 2 ? 8 : 4) : (PLANES <= 6 ? 4 : 2);
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* act = ring + SK_STAGES * SK_STAGE;  // [PLANES][win][MP][128]
  int8_t* tu = reinterpret_cast<int8_t*>(act + PLANES * win * ACT_TILE);
  int8_t* tv = tu + R * 256;
  uint64_t* full = reinterpret_cast<uint64_t*>(tv + R * 256);
  uint64_t* empty = full + SK_STAGES;
  int* last = reinterpret_cast<int*>(empty + SK_STAGES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * SK_BM;
  const int splits = gridDim.y, z = blockIdx.y;
  // split z: K units [z U / S, (z + 1) U / S) of `gran` bytes, none empty
  const int units = (K + gran - 1) / gran;
  const int kb = (int)((long long)z * units / splits) * gran;
  const int ke = min(K, (int)((long long)(z + 1) * units / splits) * gran);
  const int box0 = kb / SK_BK;
  const int nbox = (ke + SK_BK - 1) / SK_BK - box0;

  if (tid == SK_CONSUMERS) {
    asm volatile("prefetch.tensormap [%0];\n"
                 ::"l"(reinterpret_cast<uint64_t>(&tm_w)) : "memory");
  }
  for (int i = tid; i < R * 256; i += SK_THREADS) {
    tu[i] = fu[i];
    tv[i] = fv[i];
  }
  if (tid == 0) {
    for (int s = 0; s < SK_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, SK_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == SK_CONSUMERS / 32) {  // the producer: one thread, TMA only
    if (lane == 0) {
      for (int i = 0; i < nbox; ++i) {
        const int s = i % SK_STAGES;
        if (i >= SK_STAGES) mbar_wait(empty + s, (i / SK_STAGES - 1) & 1);
        mbar_expect_tx(full + s, SK_STAGE);
        tma_load_2d(ring + s * SK_STAGE, &tm_w, (box0 + i) * SK_BK, n0,
                    full + s);
      }
    }
    return;
  }

  int acc[PLANES][NACC];
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[p][i] = 0;
  uint32_t f[2][4][4];  // mapped weight fragments, double-buffered by plane
  const int a_row = warp * 16 + (lane & 15), a_half = lane >> 4;
  const int k_map = min(ke, k_valid);  // mapped planes: zero from here on

  for (int w0 = 0; w0 < nbox; w0 += win) {
    const int wn = min(win, nbox - w0);
    if (w0) {  // until the previous window's wgmmas have read its planes
      wg_wait<0>();
      consumer_sync();
    }
    // BATCH chunks of 16 bytes a thread at a time: their global loads are
    // all in flight before the first is mapped
    const int chunks = wn * MP * 8;
    for (int c0 = tid; c0 < chunks; c0 += SK_CONSUMERS * BATCH) {
      uint4 v[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int c = c0 + b * SK_CONSUMERS;
        const int r = (c >> 3) % MP;
        const int col = (box0 + w0 + c / (MP * 8)) * SK_BK + (c & 7) * 16;
        v[b] = make_uint4(0u, 0u, 0u, 0u);
        if (c < chunks && r < M && col < ke && col + 16 > kb) {
          v[b] = *reinterpret_cast<const uint4*>(A + (size_t)r * K + col);
        }
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int c = c0 + b * SK_CONSUMERS;
        if (c >= chunks) break;
        const int j = c / (MP * 8), r = (c >> 3) % MP, ch = c & 7;
        const int col = (box0 + w0 + j) * SK_BK + ch * 16;
        const uint32_t raw[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
        const int hi0 = r < M ? ke : kb, hi = r < M ? k_map : kb;
        uint32_t keep[4], o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          keep[e] = bytes_in(col + 4 * e, kb, hi);
          o[e] = raw[e] & mask_a & bytes_in(col + 4 * e, kb, hi0);
        }
        uint8_t* dst =
            act + j * ACT_TILE + r * SK_BK + ((ch ^ (r & 7)) << 4);
        *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
#pragma unroll
        for (int p = 1; p < PLANES; ++p) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[e] = map_bytes(raw[e], tu + (p - 1) * 256) & keep[e];
          }
          *reinterpret_cast<uint4*>(dst + p * win * ACT_TILE) =
              make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
    }
    fence_proxy_async();  // the planes are read by wgmma (async proxy)
    consumer_sync();

    for (int j = 0; j < wn; ++j) {
      const int i = w0 + j, s = i % SK_STAGES;
      mbar_wait(full + s, (i / SK_STAGES) & 1);
      const uint8_t* stage = ring + s * SK_STAGE;
      uint32_t raw[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        ldmatrix_x4(raw[ks], stage + a_row * SK_BK +
                                 (((ks * 2 + a_half) ^ (a_row & 7)) << 4));
      }
      fence_proxy_async();  // ordered before the TMA that refills the stage
      mbar_arrive(empty + s);
      const uint8_t* at = act + j * ACT_TILE;
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        uint32_t(&fp)[4][4] = f[p & 1];
        // the group that last read buffer p & 1 has retired
        if (p == 0 && (PLANES & 1)) {
          wg_wait<0>();
        } else {
          wg_wait<1>();
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            fp[ks][e] = p == 0 ? raw[ks][e] & mask_b
                               : map_bytes(raw[ks][e], tv + (p - 1) * 256);
          }
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          wgmma_s8<NP>(acc[p], fp[ks],
                       swizzle128_desc(at + p * win * ACT_TILE + ks * 32));
        }
        wg_commit();
      }
    }
  }
  wg_wait<0>();

  // warp w holds tile rows 16 w + g (+ 8), activation rows 8 j + 2 t (+ 1)
  // in acc[p][4 j .. 4 j + 3]
  const int g = lane >> 2, t = lane & 3;
  const int row = warp * 16 + g;
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + row + (e >> 1) * 8, mi = 8 * j + 2 * t + (e & 1);
        float o = 0.f;
#pragma unroll
        for (int p = 0; p < PLANES; ++p) {
          const float sc = scales ? scales[p] : 1.f;
          o = __fadd_rn(o, __fmul_rn(sc, (float)acc[p][4 * j + e]));
        }
        if (n < N && mi < M) C[(size_t)mi * N + n] = o;
      }
    return;
  }

  // The splits' int32 sums meet by atomic adds in the workspace,
  // [plane][gridDim.x * 64 rows][MP], which is zero between calls; the
  // tile's last block to arrive reads the totals, clears them, flushes.
  const size_t nt = (size_t)gridDim.x * SK_BM;
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        atomicAdd(ws + ((size_t)p * nt + n0 + row + (e >> 1) * 8) * MP +
                      8 * j + 2 * t + (e & 1),
                  acc[p][4 * j + e]);
      }
  consumer_sync();
  if (tid == 0) {
    // acq_rel at device scope: after the barrier, the release orders every
    // thread's adds before the arrival; the acquire orders the last
    // block's reads after every other block's adds
    int prev;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(counters + blockIdx.x) : "memory");
    *last = prev == splits - 1;
  }
  consumer_sync();
  if (!*last) return;
  for (int q = tid; q < SK_BM * MP / 4; q += SK_CONSUMERS) {
    const int n = n0 + q % SK_BM, m4 = (q / SK_BM) * 4;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      int4* sum = reinterpret_cast<int4*>(ws + ((size_t)p * nt + n) * MP + m4);
      const int4 s = __ldcg(sum);
      __stcg(sum, make_int4(0, 0, 0, 0));  // zero for the next call
      const float sc = scales ? scales[p] : 1.f;
      o[0] = __fadd_rn(o[0], __fmul_rn(sc, (float)s.x));
      o[1] = __fadd_rn(o[1], __fmul_rn(sc, (float)s.y));
      o[2] = __fadd_rn(o[2], __fmul_rn(sc, (float)s.z));
      o[3] = __fadd_rn(o[3], __fmul_rn(sc, (float)s.w));
    }
    if (n < N) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (m4 + e < M) C[(size_t)(m4 + e) * N + n] = o[e];
      }
    }
  }
  if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next call
}

struct SkArgs {
  const void *a, *fu, *fv, *scales;
  void *ws, *counters, *out;
  int m, k, n, k_valid, splits, gran, win;
  uint32_t mask_a, mask_b;
};

template <int NP, int PLANES>
cudaError_t skinny_launch(const CUtensorMap& tm, const SkArgs& g,
                          cudaStream_t s) {
  const cudaError_t err =
      repro_smem_limit<skinny_kernel<NP, PLANES>>(SK_SMEM_MAX);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((g.n + SK_BM - 1) / SK_BM), (unsigned)g.splits);
  skinny_kernel<NP, PLANES>
      <<<grid, SK_THREADS, sk_smem(PLANES, 8 * NP, g.win), s>>>(
          tm, (const int8_t*)g.a, (const int8_t*)g.fu, (const int8_t*)g.fv,
          (const float*)g.scales, (int*)g.ws, (int*)g.counters,
          (float*)g.out, g.m, g.k, g.n, g.k_valid, g.mask_a, g.mask_b,
          g.gran, g.win);
  return cudaGetLastError();
}

template <int NP>
cudaError_t skinny_dispatch(int planes, const CUtensorMap& tm,
                            const SkArgs& g, cudaStream_t s) {
  switch (planes) {
    case 1: return skinny_launch<NP, 1>(tm, g, s);
    case 2: return skinny_launch<NP, 2>(tm, g, s);
    case 3: return skinny_launch<NP, 3>(tm, g, s);
    case 4: return skinny_launch<NP, 4>(tm, g, s);
    case 5: return skinny_launch<NP, 5>(tm, g, s);
    case 6: return skinny_launch<NP, 6>(tm, g, s);
    case 7: return skinny_launch<NP, 7>(tm, g, s);
    case 8: return skinny_launch<NP, 8>(tm, g, s);
    case 9: return skinny_launch<NP, 9>(tm, g, s);
    default: return cudaErrorInvalidValue;
  }
}

// Whether repro_qgemm_skinny takes (m, k, n, k_valid, rank, splits, gran).
bool skinny_args_ok(int m, int k, int n, int k_valid, int rank, int splits,
                    int gran) {
  return m >= 1 && m <= 32 && k >= 16 && k % 16 == 0 && n >= 1 &&
         k_valid >= 1 && k_valid <= k && rank >= 0 && rank <= SK_MAX_RANK &&
         (gran == 32 || gran == SK_BK) && splits >= 1 && splits <= 65535 &&
         splits <= (k + gran - 1) / gran;
}

// Activation rows in the MMA (8 NP) and the K boxes of activation planes a
// block holds (`win`): those of the widest split, as many as fit the
// activation budget.
void skinny_layout(int m, int k, int planes, int splits, int gran, int* mp,
                   int* win) {
  *mp = m <= 8 ? 8 : 32;
  const int units = (k + gran - 1) / gran;
  int boxes = 1;
  for (int z = 0; z < splits; ++z) {
    const int kb = (int)((long long)z * units / splits) * gran;
    const int ke = std::min(k, (int)((long long)(z + 1) * units / splits) *
                                   gran);
    boxes = std::max(boxes, (ke + SK_BK - 1) / SK_BK - kb / SK_BK);
  }
  const int fit = SK_ACT_BUDGET / (planes * *mp * SK_BK);
  *win = std::max(1, std::min(boxes, fit));
}

template <int NP, int PLANES = 1>
const void* skinny_fn(int planes) {
  if constexpr (PLANES <= SK_MAX_RANK + 1) {
    return planes == PLANES ? (const void*)skinny_kernel<NP, PLANES>
                            : skinny_fn<NP, PLANES + 1>(planes);
  } else {
    return nullptr;
  }
}

}  // namespace

// Query kernel 3 (query.cu): args (m, k, n, rank, splits, gran), as
// repro_qgemm_skinny takes them (k_valid = k).
int repro_query_skinny(int kernel, const int* a, long long* out) {
  const int m = a[0], k = a[1], n = a[2], rank = a[3], splits = a[4],
            gran = a[5];
  if (kernel != 3 || !skinny_args_ok(m, k, n, k, rank, splits, gran)) {
    return (int)cudaErrorInvalidValue;
  }
  int mp, win;
  skinny_layout(m, k, rank + 1, splits, gran, &mp, &win);
  const void* f = mp == 8 ? skinny_fn<1>(rank + 1) : skinny_fn<4>(rank + 1);
  return repro_query_fill(
      f, sk_smem(rank + 1, mp, win), SK_SMEM_MAX, SK_THREADS,
      dim3((unsigned)((n + SK_BM - 1) / SK_BM), (unsigned)splits), out);
}

// a (m, k) int8, bt (n, k) int8 K-major; fu, fv (rank, 256) int8 and scales
// (rank + 1) f32, all three null at rank 0; ws the int32 workspace
// ((rank + 1) x ceil(n / 64) 64 x (m <= 8 ? 8 : 32), null with one split)
// and counters (ceil(n / 64) int32), both zero between calls; out (m, n)
// f32.
REPRO_API int repro_qgemm_skinny(const void* a, const void* bt, const void* fu,
                                 const void* fv, const void* scales, void* ws,
                                 void* counters, void* out, int m, int k,
                                 int n, int k_valid, int rank, int mask_a,
                                 int mask_b, int splits, int gran,
                                 void* stream) {
  if (!skinny_args_ok(m, k, n, k_valid, rank, splits, gran) || !counters ||
      (splits > 1 && !ws) || (rank && (!fu || !fv || !scales))) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap tm;
  if (!tensor_map_2d(&tm, bt, n, k, SK_BM)) return (int)cudaErrorInvalidValue;
  const int planes = rank + 1;
  int mp, win;
  skinny_layout(m, k, planes, splits, gran, &mp, &win);
  const SkArgs g{a, fu, fv, scales, ws, counters, out, m, k, n, k_valid,
                 splits, gran, win, repro_word_mask(mask_a),
                 repro_word_mask(mask_b)};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(mp == 8 ? skinny_dispatch<1>(planes, tm, g, s)
                       : skinny_dispatch<4>(planes, tm, g, s));
}
