// Online-softmax (flash) attention on (bh, s, d) tensors, f32 or bf16 in,
// f32 accumulation, output in the input type.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (_kernel),
// the Pallas TPU kernel of the prefill attention (impl="flash").
//
// Computes O = softmax(Q K^T / sqrt(d)) V per head-batch, causal by global
// index (q_i sees kv_j for j <= i) when asked; kv tiles wholly above the
// diagonal are skipped.  Masked scores take -1e30 as in the reference.
//
// Bound on the H100: at the serving shape (bh 32, s 128, d 64, causal) one
// call moves 4.2 MB (Q, K, V read once, O written once: 1.25 us at 3.35
// TB/s) and does about 68 MFLOP, so neither bytes nor arithmetic bound it:
// latency does, the length of each block's chain of dependent steps and
// how many blocks share the 132 SMs.  Design:
//   - one warp per block owns 8 query rows (f32) or 16 (bf16, the MMA's
//     height), so at s = 128 the f32 grid is 16 x bh = 512 blocks, about
//     one per SM sub-partition; the heaviest causal blocks (the last query
//     rows) are launched first;
//   - Q is staged once and 32-row K and V tiles arrive through a cp.async
//     double buffer (pad rows zero-filled), so the copy of tile j + 1
//     overlaps the arithmetic of tile j; P goes through a shared-memory
//     tile from the layout that computes it to the one that consumes it;
//   - f32: register-tiled FP32 FMAs.  Each lane holds a 2 x 4 micro-tile of
//     S (rows r + 4i, kv columns c + 8j) and 2 rows x d/8 columns of O, so
//     each shared-memory float4 feeds 8 or more independent FMA chains and
//     no shuffle sits on them; the running max and denominator reduce over
//     the 8 lanes of a row group.  Each score and each output is an in-order
//     f32 FMA chain, as in a plain f32 GEMM.  3xTF32 tensor-core products
//     held the 2e-6 kernel contract too, but they round otherwise than FMA
//     chains: on the card they moved int8 codes at the o-projection input
//     of the 2-layer trunc2x2 model check (8.1e-2 on its logits, limit
//     1e-4), which the FMA kernel does not;
//   - bf16: tensor-core tiles (mma.sync m16n8k16, f32 accumulation); each
//     lane holds two rows of S, whose max and denominator reduce over a
//     quad.
//   - shared-memory row strides are padded so the reads are conflict-free.
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int FA_BKV = 32;                   // kv rows per tile
constexpr int FA_LDP = FA_BKV + 8;           // P tile row stride (floats)
constexpr float FA_NEG_INF = -1e30f;

// Shared-memory row stride of Q, K and V, in elements of T: 4 mod 32 words
// (f32) or 4 mod 32 32-bit words of bf16 pairs.
template <typename T, int D>
__host__ __device__ constexpr int fa_ld() {
  return std::is_same<T, float>::value ? D + 4 : D + 8;
}

__device__ __forceinline__ float row_max8(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float row_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// ---------------------------- f32: FMA tiles -------------------------------
// 8 query rows per block.  Lane (rg, cg) = (lane / 8, lane % 8) owns query
// rows rg + 4i (i < 2), kv columns cg + 8j (j < 4) of each S tile and
// output columns nc * 32 + cg * 4 .. + 3 (nc < D / 32) of O.
template <int D>
struct FmaTile {
  static constexpr int BQ = 8;
  static constexpr int RI = BQ / 4;           // rows per lane
  static constexpr int LD = fa_ld<float, D>();
  static constexpr int NC = D / 32;
  float o[RI][NC][4];
  float m[RI], l[RI];
  int rg, cg;

  __device__ __forceinline__ void init(int lane) {
    rg = lane >> 3;
    cg = lane & 7;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      m[i] = FA_NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int nc = 0; nc < NC; ++nc)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][nc][e] = 0.f;
    }
  }

  __device__ __forceinline__ void step(const float* Qs, const float* Ks,
                                       const float* Vs, float* Ps, int q0,
                                       int kv0, int skv, int causal,
                                       float scale) {
    float s[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 q[RI], k[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        q[i] = *reinterpret_cast<const float4*>(Qs + (rg + 4 * i) * LD + c);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        k[j] = *reinterpret_cast<const float4*>(Ks + (cg + 8 * j) * LD + c);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = fmaf(q[i].x, k[j].x, s[i][j]);
          a = fmaf(q[i].y, k[j].y, a);
          a = fmaf(q[i].z, k[j].z, a);
          s[i][j] = fmaf(q[i].w, k[j].w, a);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + rg + 4 * i;
      float mx = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + cg + 8 * j;
        float v = s[i][j] * scale;
        if (col >= skv || (causal && col > row)) v = FA_NEG_INF;
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
      const float m_new = fmaxf(m[i], row_max8(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            kv0 + cg + 8 * j < skv ? expf(s[i][j] - m_new) : 0.f;
        Ps[(rg + 4 * i) * FA_LDP + cg + 8 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + row_sum8(sum);
      m[i] = m_new;
#pragma unroll
      for (int nc = 0; nc < NC; ++nc)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][nc][e] *= alpha;
    }
    __syncwarp();
#pragma unroll 2
    for (int j = 0; j < FA_BKV; j += 4) {
      float4 p[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        p[i] = *reinterpret_cast<const float4*>(Ps + (rg + 4 * i) * FA_LDP +
                                                j);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int nc = 0; nc < NC; ++nc) {
          const float4 v = *reinterpret_cast<const float4*>(
              Vs + (j + jj) * LD + nc * 32 + cg * 4);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            const float pj = jj == 0 ? p[i].x : jj == 1 ? p[i].y
                                              : jj == 2 ? p[i].z : p[i].w;
            o[i][nc][0] = fmaf(pj, v.x, o[i][nc][0]);
            o[i][nc][1] = fmaf(pj, v.y, o[i][nc][1]);
            o[i][nc][2] = fmaf(pj, v.z, o[i][nc][2]);
            o[i][nc][3] = fmaf(pj, v.w, o[i][nc][3]);
          }
        }
    }
  }

  __device__ __forceinline__ void store(float* Ob, int q0, int sq) const {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + rg + 4 * i;
      if (row >= sq) continue;
      const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
        *reinterpret_cast<float4*>(Ob + (size_t)row * D + nc * 32 + cg * 4) =
            make_float4(o[i][nc][0] / li, o[i][nc][1] / li,
                        o[i][nc][2] / li, o[i][nc][3] / li);
      }
    }
  }
};

// --------------------------- bf16: tensor cores ----------------------------
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t word(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 query rows per block.  Lane (g, t) = (lane / 4, lane % 4) holds the
// m16n8 accumulator fragments: rows g and g + 8, columns 2t and 2t + 1 of
// each n8 tile.
template <int D>
struct MmaTile {
  static constexpr int BQ = 16;
  static constexpr int LD = fa_ld<__nv_bfloat16, D>();
  float o[D / 8][4];
  float m[2], l[2];
  int g, t;

  __device__ __forceinline__ void init(int lane) {
    g = lane >> 2;
    t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = FA_NEG_INF;
      l[h] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  }

  __device__ __forceinline__ void step(const __nv_bfloat16* Qs,
                                       const __nv_bfloat16* Ks,
                                       const __nv_bfloat16* Vs, float* Ps,
                                       int q0, int kv0, int skv, int causal,
                                       float scale) {
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      const uint32_t a[4] = {word(Qs + g * LD + c), word(Qs + (g + 8) * LD + c),
                             word(Qs + g * LD + c + 8),
                             word(Qs + (g + 8) * LD + c + 8)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LD + c;
        const uint32_t b[2] = {word(kr), word(kr + 8)};
        mma_bf16(s[nt], a, b);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + g + 8 * h;
      float mx = FA_NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kv0 + nt * 8 + 2 * t + e;
          float v = s[nt][2 * h + e] * scale;
          if (col >= skv || (causal && col > row)) v = FA_NEG_INF;
          s[nt][2 * h + e] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = expf(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kv0 + nt * 8 + 2 * t + e;
          const float p = col < skv ? expf(s[nt][2 * h + e] - m_new) : 0.f;
          s[nt][2 * h + e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = alpha * l[h] + sum;
      m[h] = m_new;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        o[nt][2 * h] *= alpha;
        o[nt][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      *reinterpret_cast<float2*>(Ps + g * FA_LDP + nt * 8 + 2 * t) =
          make_float2(s[nt][0], s[nt][1]);
      *reinterpret_cast<float2*>(Ps + (g + 8) * FA_LDP + nt * 8 + 2 * t) =
          make_float2(s[nt][2], s[nt][3]);
    }
    __syncwarp();
    const uint16_t* Vb = reinterpret_cast<const uint16_t*>(Vs);
#pragma unroll
    for (int kk = 0; kk < FA_BKV / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      auto pair = [&](int r, int col) {
        const float2 v = *reinterpret_cast<const float2*>(Ps + r * FA_LDP +
                                                          col);
        return pack_bf16(v.x, v.y);
      };
      const uint32_t a[4] = {pair(g, c), pair(g + 8, c), pair(g, c + 8),
                             pair(g + 8, c + 8)};
      const uint16_t* vr = Vb + c * LD + g;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const uint16_t* v = vr + nt * 8;
        const uint32_t b[2] = {
            (uint32_t)v[0] | ((uint32_t)v[LD] << 16),
            (uint32_t)v[8 * LD] | ((uint32_t)v[9 * LD] << 16)};
        mma_bf16(o[nt], a, b);
      }
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16* Ob, int q0,
                                        int sq) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + g + 8 * h;
      if (row >= sq) continue;
      const float lh = fmaxf(l[h], 1e-30f);
      __nv_bfloat16* out = Ob + (size_t)row * D + 2 * t;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        *reinterpret_cast<__nv_bfloat162*>(out + nt * 8) =
            __floats2bfloat162_rn(o[nt][2 * h] / lh, o[nt][2 * h + 1] / lh);
      }
    }
  }
};

// ------------------------------- the kernel --------------------------------
template <typename T, int D>
using TileOf = typename std::conditional<std::is_same<T, float>::value,
                                         FmaTile<D>, MmaTile<D>>::type;

template <typename T, int D>
constexpr size_t fa_smem_bytes() {
  return (size_t)(TileOf<T, D>::BQ + 4 * FA_BKV) * fa_ld<T, D>() *
             sizeof(T) +
         (size_t)TileOf<T, D>::BQ * FA_LDP * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(32)
flash_kernel(const T* __restrict__ Q, const T* __restrict__ K,
             const T* __restrict__ V, T* __restrict__ O, int sq, int skv,
             int causal, float scale) {
  using Tile = TileOf<T, D>;
  constexpr int BQ = Tile::BQ;
  constexpr int LD = Tile::LD;
  constexpr int CH = D * (int)sizeof(T) / 16;  // 16-byte chunks per row
  constexpr int PER = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char fa_smem[];
  T* Qs = reinterpret_cast<T*>(fa_smem);       // [BQ][LD]
  T* Ks = Qs + BQ * LD;                        // [2][FA_BKV][LD]
  T* Vs = Ks + 2 * FA_BKV * LD;                // [2][FA_BKV][LD]
  float* Ps = reinterpret_cast<float*>(Vs + 2 * FA_BKV * LD);  // [BQ][LDP]
  const int lane = threadIdx.x;
  const size_t base = (size_t)blockIdx.y;
  const T* Kb = K + base * skv * D;
  const T* Vb = V + base * skv * D;
  // heaviest (last) query blocks first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;

  auto copy_rows = [&](T* dst, const T* src, int rows, int row0, int n) {
    for (int i = lane; i < rows * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * PER;
      const bool in = row0 + r < n;
      repro_cp_async16(dst + r * LD + c,
                       src + (size_t)(in ? row0 + r : 0) * D + c, in);
    }
  };
  auto load_kv = [&](int buf, int tile) {
    copy_rows(Ks + buf * FA_BKV * LD, Kb, FA_BKV, tile * FA_BKV, skv);
    copy_rows(Vs + buf * FA_BKV * LD, Vb, FA_BKV, tile * FA_BKV, skv);
  };

  const int q_last = min(q0 + BQ, sq) - 1;
  int n_tiles = (skv + FA_BKV - 1) / FA_BKV;
  if (causal) n_tiles = min(n_tiles, q_last / FA_BKV + 1);

  copy_rows(Qs, Q + base * sq * D, BQ, q0, sq);
  load_kv(0, 0);
  repro_cp_async_commit();
  Tile tile;
  tile.init(lane);
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_kv((j + 1) & 1, j + 1);
      repro_cp_async_commit();
      repro_cp_async_wait<1>();
    } else {
      repro_cp_async_wait<0>();
    }
    __syncwarp();
    tile.step(Qs, Ks + (j & 1) * FA_BKV * LD, Vs + (j & 1) * FA_BKV * LD,
              Ps, q0, j * FA_BKV, skv, causal, scale);
    __syncwarp();
  }
  tile.store(O + base * sq * D, q0, sq);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int sq, int skv, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = fa_smem_bytes<T, D>();
  const cudaError_t err = repro_smem_limit<flash_kernel<T, D>>((int)smem);
  if (err != cudaSuccess) return err;
  constexpr int BQ = TileOf<T, D>::BQ;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_kernel<T, D><<<grid, 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
int query_one(int bh, int sq, long long* out) {
  constexpr size_t smem = fa_smem_bytes<T, D>();
  constexpr int BQ = TileOf<T, D>::BQ;
  return repro_query_fill((const void*)flash_kernel<T, D>, (long long)smem,
                          (long long)smem, 32, dim3((sq + BQ - 1) / BQ, bh),
                          out);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int bh, int sq, int skv, int d, int causal,
                       float scale, cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, bh, sq, skv, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, bh, sq, skv, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, bh, sq, skv, causal, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, bh, sq, skv, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int query_d(int bh, int sq, int d, long long* out) {
  switch (d) {
    case 32: return query_one<T, 32>(bh, sq, out);
    case 64: return query_one<T, 64>(bh, sq, out);
    case 128: return query_one<T, 128>(bh, sq, out);
    case 256: return query_one<T, 256>(bh, sq, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Query kernel 7 (query.cu): args (bh, sq, skv, d, is_bf16), as
// repro_flash_attention takes them.
int repro_query_flash(int kernel, const int* a, long long* out) {
  const int bh = a[0], sq = a[1], skv = a[2], d = a[3];
  if (kernel != 7 || bh < 1 || bh > 65535 || sq < 1 || skv < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return a[4] ? query_d<__nv_bfloat16>(bh, sq, d, out)
              : query_d<float>(bh, sq, d, out);
}

REPRO_API int repro_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int bh, int sq,
                                    int skv, int d, int causal, int is_bf16,
                                    float scale, void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || skv < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, o, bh, sq, skv, d, causal,
                                          scale, s)
              : dispatch_d<float>(q, k, v, o, bh, sq, skv, d, causal, scale,
                                  s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
