// f32 K1 and f32 K3 at the DiT's sequences (T <= 256, D 56-80): the port of
// lfm_tpu/kernels/flash_attention.py::attention_small (`_attn_small_kernel`)
// and ::attention_small_bwd (`_attn_small_bwd_kernel`) for f32 models,
// redesigned for the H100's CUDA cores. The f32 DiT train step
// (`train --precision f32`, the reference's own numerics at 256 px) runs
// the forward at (N, 256, H, 64) twice a block (forward and the recompute
// under grad checkpointing) and the backward once.
//
// Per (sample, head), with s = scale q k^T (scale = 1/sqrt(D)):
//   K1:  m = max_k s, e = exp(s - m), l = sum_k e, o = (e v) / l
//   K3:  p = e / l, dv = p^T do, dp = do v^T, delta = rowsum(dp * p),
//        ds = p (dp - delta), dq = scale ds k, dk = scale ds^T q
// all in f32 (f32 products, f32 sums, the exact row max): only the order of
// the f32 sums differs from the TPU kernel's. No TF32 and no tensor core:
// an f32 model is f32 throughout, so the products are f32 FMA.
//
// What bounds them on the H100: at (N, 256, 16, 64) K1 moves 4 T H D * 4
// bytes a sample against 4 T^2 H D flops, and K3 7 T H D * 4 bytes against
// 10 T^2 H D: both are bound by the 67 TFLOP/s of the f32 units (at T = 256
// about 128 flops a byte). The design is built to feed the FMA units:
//  - one pass over the whole key row. At T <= 256 a head's K and V take 64
//    KB each in f32, so a CTA of 256 threads keeps its 64 query rows and
//    all TK keys (T rounded up to 64, 128 or 256) in shared memory, forms
//    the whole row of S in registers, takes the exact max, exp and sum,
//    and then runs P V. K1 does 4 T^2 D flops, not the 6 of a second sweep;
//  - register-blocked products. Each thread owns an 8 x (TK / 32) tile of
//    S (rows ty + 8i, keys tx + 32j) and reads q and k as float4 along D
//    from rows padded by 16 bytes (DP + 4 floats, so the 8 rows a warp reads
//    at once fall on distinct banks): 16 shared loads for 256 FMA at TK =
//    256. The products with P or dS take 4 x 4 tiles of the output (rows
//    ty + 16i, four columns; 8 shared loads for 64 FMA) for dq, and for o
//    at DP 80; 8 x 4 tiles (12 loads for 128 FMA) for dk and dv at DP 64
//    and for o at DP 64, where two groups of 128 threads each sum one half
//    of the keys and the halves are added;
//  - loads overlapped with math. Everything arrives by 16-byte cp.async
//    (rows past T and columns past D zero-filled) in two commit groups: the
//    operands of the first product, then those of the second, which load
//    under the first product. The dk/dv kernel streams its 64-query chunks
//    through a ring of two stages, so chunk c + 2 loads under chunk c;
//  - K3 keeps the FlashAttention-2 split with no atomics (deterministic
//    sums). attn_row_bwd_dq_kernel takes the whole row of s and dp once per
//    query tile: m, l, p, delta, ds, dq (6 T^2 D), and writes m, l and
//    delta (3 N H T floats of flash_attention.bwd_stats_scratch).
//    attn_row_bwd_dkdv_kernel takes 128 keys (64 at DP 80) and recomputes
//    s^T and dp^T per query chunk from those statistics (8 T^2 D): 14 T^2 D
//    in all, not the 18 of an online pass and a second sweep. It forms p as the
//    dq kernel does, so its p is the dq kernel's bit for bit. It streams the
//    queries, so it takes any T: past T = 256 it follows the dq kernel of
//    attention_long_f32.cuh, which writes the same statistics.
// Shared memory (DP 64 / 80, TK 256): K1 160 / 197 KB (P takes K's buffer
// once S is formed), the dq kernel 177 / 218 KB (dS takes V's), the dk/dv
// kernel 206 / 162 KB: one CTA an SM (two of K1's at TK 128).
//
// The f32 sums: s and dp over D, and dq over keys, each one chain in order,
// as the plain version's f32 GEMMs sum them (dq summed in 64-key segments
// was measured 3x further from the plain version); dk and dv over queries,
// each 64-query chunk a fresh partial added to the total (shorter chains:
// measured closer to float64 than one chain, and so further from the plain
// version, PERF.md); o at DP 64 in two halves of the keys
// (closer to the plain version and to float64 than one chain, as measured);
// l and delta directly (a tree over the row's threads), where the older
// kernels rescale them online. delta is rowsum(p dp) after l, as the TPU
// kernel forms it. The row max m is taken of the unscaled s and scaled once
// (rounding is monotonic, so it is the max of the rounded scale s), and
// scale s - m is one FMA, as the older kernels' compiled code forms it:
// measured against the plain version (which rounds scale s first), every
// output's error is then at or below the older kernels', where rounding
// scale s first left dk one ulp above theirs at D = 72.
#pragma once

#include "common.cuh"

namespace lfm {
namespace row32 {

constexpr int THREADS = 256;
constexpr int BQ = 64;     // query rows of a K1 / dq CTA
constexpr int CHUNK = 64;  // query rows of a dk/dv stage
constexpr int MAX_T = 256;

// 4-byte global -> shared copy, zero-filled when pred is false
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

template <int DP, int TK>
struct RowLayout {
  static constexpr int LD = DP + 4;   // q/k/v/do row in shared memory (floats)
  static constexpr int LDP = TK + 4;  // P / dS row
  static constexpr int QROWS = BQ * LD;
  static constexpr int KROWS = TK * LD;
  static constexpr int PBUF = BQ * LDP;
  static constexpr int RED = 4 * BQ;  // one row reduction: 4 warps x 64 rows
  // K1: q, k (then p), v, 2 reductions
  static constexpr int FWD_K = QROWS;
  static constexpr int FWD_V = FWD_K + (KROWS > PBUF ? KROWS : PBUF);
  static constexpr int FWD_RED = FWD_V + KROWS;
  static constexpr size_t FWD_BYTES = 4 * size_t(FWD_RED + 2 * RED);
  // dq: q, do, k, v (then ds), 3 reductions
  static constexpr int DQ_DO = QROWS;
  static constexpr int DQ_K = 2 * QROWS;
  static constexpr int DQ_V = DQ_K + KROWS;
  static constexpr int DQ_RED = DQ_V + (KROWS > PBUF ? KROWS : PBUF);
  static constexpr size_t DQ_BYTES = 4 * size_t(DQ_RED + 3 * RED);
};

// The dk/dv kernel: BK = 16 RM keys a CTA (a thread's tiles have RM key
// rows): 128 at DP 64, 64 at DP 80, where 128 keys would not fit
template <int DP>
struct DkdvLayout {
  static constexpr int RM = DP <= 64 ? 8 : 4;
  static constexpr int BK = 16 * RM;
  static constexpr int LD = DP + 4;
  static constexpr int LDP = CHUNK + 4;
  static constexpr int KROWS = BK * LD, QROWS = CHUNK * LD;
  static constexpr int V = KROWS, STAGE0 = 2 * KROWS;
  static constexpr int STAGE = 2 * QROWS + 3 * CHUNK;  // q, do, then m, l, delta
  static constexpr int P = STAGE0 + 2 * STAGE, DS = P + BK * LDP;
  static constexpr size_t BYTES = 4 * size_t(DS + BK * LDP);
};

// rows [row0, row0 + ROWS) x columns [0, DP) of a slab into a tile of row
// stride DP + 4; rows >= T and columns >= D zero-filled (D % 8 == 0). Thread
// t copies the 16-byte chunks t, t + THREADS, ... in row-major order. Up to
// 128 rows (a ring stage, a chunk, a query tile) the loop is unrolled, so a
// copy costs a few instructions (measured faster in the kernels of
// attention_long_f32.cuh); a whole row of 256 keys keeps the plain loop
// (measured faster there in K1).
template <int DP, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* base, long ld, int row0, int T,
                                          int D) {
  constexpr int C4 = DP / 4, N = ROWS * C4;
  if constexpr (ROWS <= 128) {
    const float* src = base + long(row0) * ld;
    const int rows = T - row0;
#pragma unroll
    for (int k = 0; k < (N + THREADS - 1) / THREADS; ++k) {
      const int id = int(threadIdx.x) + k * THREADS;
      if (N % THREADS == 0 || id < N) {
        const int r = id / C4, c = (id % C4) * 4;
        const bool ok = r < rows && c < D;
        cp_async16(dst + r * (DP + 4) + c, ok ? src + long(r) * ld + c : base, ok);
      }
    }
  } else {
    for (int id = threadIdx.x; id < N; id += THREADS) {
      const int r = id / C4, c = (id % C4) * 4;
      const bool ok = row0 + r < T && c < D;
      cp_async16(dst + r * (DP + 4) + c, ok ? base + long(row0 + r) * ld + c : base, ok);
    }
  }
}

// acc[i][j] += sum_d A[r0 + RS i][d] B[c0 + CS j][d], d in order; A and B
// have rows of DP + 4 floats; the loop unrolled U times
template <int DP, int RM, int RN, int RS, int CS, int U = 2>
__device__ __forceinline__ void nt(float (&acc)[RM][RN], const float* A, int r0, const float* B,
                                   int c0) {
  constexpr int LD = DP + 4;
#pragma unroll U
  for (int d = 0; d < DP; d += 4) {
    float4 a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (r0 + RS * i) * LD + d);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(B + (c0 + CS * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
  }
}

// acc[i][0..3] += sum_k A[r0 + RS i][k] B[k][c..c+3], k in order over
// [0, klen), klen % 4 == 0; the loop unrolled U times
template <int RM, int LDA, int LDB, int RS = 16, int U = 2>
__device__ __forceinline__ void nn(float (&acc)[RM][4], const float* A, int r0, const float* B,
                                   int c, int klen) {
#pragma unroll U
  for (int k = 0; k < klen; k += 4) {
    float4 a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (r0 + RS * i) * LDA + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(B + (k + kk) * LDB + c);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
        acc[i][0] = fmaf(av, b.x, acc[i][0]);
        acc[i][1] = fmaf(av, b.y, acc[i][1]);
        acc[i][2] = fmaf(av, b.z, acc[i][2]);
        acc[i][3] = fmaf(av, b.w, acc[i][3]);
      }
    }
  }
}

// The RM x 4 output tiles of an RG RM x DP product: tile `it` has rows ty +
// RG i and columns 4 cg .. 4 cg + 3. Where DP / 4 is a multiple of 8 a warp
// takes 4 row groups x 8 column groups (one 128-byte row of B a load; a
// quarter-warp one row group, so its A loads read one address); at DP 80
// the tiles run in order (RG 16: threads 0-63 take a second one).
template <int DP, int RG = 16>
struct OutTiles {
  static constexpr int CG = DP / 4;
  static constexpr int COUNT = RG * CG;
  static constexpr int PER_THREAD = (COUNT + THREADS - 1) / THREADS;
  static __device__ __forceinline__ void at(int it, int& ty, int& cg) {
    if constexpr (CG % 8 == 0) {
      constexpr int WX = CG / 8;
      const int w = it / 32, lane = it % 32;
      ty = (w / WX) * 4 + lane / 8;
      cg = (w % WX) * 8 + lane % 8;
    } else {
      ty = it / CG;
      cg = it % CG;
    }
  }
};

// store an RM x 4 tile times `mul` at rows row0 + ty + RS i of an (N, T,
// row) slab; rows >= T and columns >= D are dropped
template <int RS = 16, int RM>
__device__ __forceinline__ void store_tile(const float (&acc)[RM][4], const float (&mul)[RM],
                                           float* base, long ld, int row0, int ty, int c, int T,
                                           int D) {
  if (c >= D) return;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + ty + RS * i;
    if (r < T)
      *reinterpret_cast<float4*>(base + long(r) * ld + c) =
          make_float4(acc[i][0] * mul[i], acc[i][1] * mul[i], acc[i][2] * mul[i],
                      acc[i][3] * mul[i]);
  }
}

// The S tile of a K1 / dq thread: rows ty + 8i of the CTA's 64, keys tx + 32j.
// A warp holds 4 rows x 8 keys of each (i, j): its q loads hit 4 rows, its k
// loads 8 consecutive rows, each on distinct banks.
__device__ __forceinline__ void s_thread(int& ty, int& tx) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ty = (warp / 4) * 4 + lane / 8;
  tx = (warp % 4) * 8 + lane % 8;
}

// Reduce v (one value per row ty + 8i) across the 32 threads of each row:
// row_partials folds the 8 lanes by shuffle and writes each warp's partial
// to red[4][64]; after a __syncthreads, row_total combines the 4 in a fixed
// order (every thread gets the same bits).
template <bool MAX>
__device__ __forceinline__ float combine(float a, float b) {
  return MAX ? fmaxf(a, b) : a + b;
}
template <bool MAX>
__device__ __forceinline__ void row_partials(float (&v)[8], float* red, int ty) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      v[i] = combine<MAX>(v[i], __shfl_xor_sync(0xffffffffu, v[i], off));
  }
  const int lane = threadIdx.x % 32, wx = (threadIdx.x / 32) % 4;
  if (lane % 8 == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red[wx * BQ + ty + 8 * i] = v[i];
  }
}
template <bool MAX>
__device__ __forceinline__ float row_total(const float* red, int row) {
  float t = red[row];
#pragma unroll
  for (int w = 1; w < 4; ++w) t = combine<MAX>(t, red[w * BQ + row]);
  return t;
}

// K1: one CTA per 64 query rows of one (sample, head); TK = T rounded up
// to 64, 128 or 256.
template <int DP, int TK>
__global__ void __launch_bounds__(THREADS, 1)
attn_row_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int T, int D, long ldq,
                long ldk, long ldv, long ldo, float scale) {
  using L = RowLayout<DP, TK>;
  using O = OutTiles<DP>;
  constexpr int J = TK / 32;
  extern __shared__ __align__(16) float sm[];
  float *qs = sm, *ks = sm + L::FWD_K, *ps = ks, *vs = sm + L::FWD_V;
  float *red_m = sm + L::FWD_RED, *red_l = red_m + L::RED;
  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const long hd = long(h) * D;

  load_rows<DP, BQ>(qs, q + long(n) * T * ldq + hd, ldq, q0, T, D);
  load_rows<DP, TK>(ks, k + long(n) * T * ldk + hd, ldk, 0, T, D);
  cp_async_commit();
  load_rows<DP, TK>(vs, v + long(n) * T * ldv + hd, ldv, 0, T, D);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  int ty, tx;
  s_thread(ty, tx);
  float s[8][J];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) s[i][j] = 0.0f;
  nt<DP, 8, J, 8, 32>(s, qs, ty, ks, tx);

  float part[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    part[i] = -INFINITY;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      s[i][j] = tx + 32 * j < T ? s[i][j] : -INFINITY;
      part[i] = fmaxf(part[i], s[i][j]);
    }
  }
  row_partials<true>(part, red_m, ty);
  __syncthreads();  // every thread is done with k: p takes its buffer
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float m = __fmul_rn(scale, row_total<true>(red_m, ty + 8 * i));
    part[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float e = expf(fmaf(scale, s[i][j], -m));
      part[i] += e;
      ps[(ty + 8 * i) * L::LDP + tx + 32 * j] = e;
    }
  }
  row_partials<false>(part, red_l, ty);
  cp_async_wait<0>();
  __syncthreads();

  const int klen = min(TK, (T + 3) & ~3);
  float* ob = o + long(n) * T * ldo + hd;
  if constexpr (DP == 64) {
    // two groups of 128 threads, each an 8 x 4 tile of o (rows oy + 8i,
    // columns 4 cg) over one half of the keys; the second half's sums are
    // added to the first's through q's buffer, dead since S
    const int g = threadIdx.x / 128, wg = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int oy = (wg / 2) * 4 + lane / 8, cg = (wg % 2) * 8 + lane % 8;
    const int kh = (klen / 8) * 4, kb = g ? kh : 0, ke = g ? klen : kh;
    float acc[8][4] = {};
    nn<8, L::LDP, L::LD, 8>(acc, ps + kb, oy, vs + kb * L::LD, 4 * cg, ke - kb);
    float* half = qs + (oy * L::LD + 4 * cg);
    if (g == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(half + 8 * i * L::LD) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    if (g == 0) {
      float inv_l[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 b = *reinterpret_cast<const float4*>(half + 8 * i * L::LD);
        acc[i][0] += b.x, acc[i][1] += b.y, acc[i][2] += b.z, acc[i][3] += b.w;
        inv_l[i] = 1.0f / row_total<false>(red_l, oy + 8 * i);
      }
      store_tile<8>(acc, inv_l, ob, ldo, q0, oy, 4 * cg, T, D);
    }
  } else {
#pragma unroll
    for (int slot = 0; slot < O::PER_THREAD; ++slot) {
      const int it = threadIdx.x + slot * THREADS;
      if (it >= O::COUNT) break;
      int oy, cg;
      O::at(it, oy, cg);
      float acc[4][4] = {};
      nn<4, L::LDP, L::LD>(acc, ps, oy, vs, 4 * cg, klen);
      float inv_l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) inv_l[i] = 1.0f / row_total<false>(red_l, oy + 16 * i);
      store_tile(acc, inv_l, ob, ldo, q0, oy, 4 * cg, T, D);
    }
  }
}

// K3, kernel 1: dq and the row statistics of 64 query rows.
template <int DP, int TK>
__global__ void __launch_bounds__(THREADS, 1)
attn_row_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       float* __restrict__ dq, float* __restrict__ stats, int T, int H, int D,
                       long ldq, long ldk, long ldv, long lddo, long ldg, float scale) {
  using L = RowLayout<DP, TK>;
  using O = OutTiles<DP>;
  constexpr int J = TK / 32;
  extern __shared__ __align__(16) float sm[];
  float *qs = sm, *dos = sm + L::DQ_DO, *ks = sm + L::DQ_K, *vs = sm + L::DQ_V, *dss = vs;
  float *red_m = sm + L::DQ_RED, *red_l = red_m + L::RED, *red_pd = red_l + L::RED;
  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const long hd = long(h) * D;

  load_rows<DP, BQ>(qs, q + long(n) * T * ldq + hd, ldq, q0, T, D);
  load_rows<DP, TK>(ks, k + long(n) * T * ldk + hd, ldk, 0, T, D);
  cp_async_commit();
  load_rows<DP, BQ>(dos, dout + long(n) * T * lddo + hd, lddo, q0, T, D);
  load_rows<DP, TK>(vs, v + long(n) * T * ldv + hd, ldv, 0, T, D);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  int ty, tx;
  s_thread(ty, tx);
  float s[8][J], dp[8][J];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) s[i][j] = dp[i][j] = 0.0f;
  nt<DP, 8, J, 8, 32>(s, qs, ty, ks, tx);
  float part[8], part2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    part[i] = -INFINITY;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      s[i][j] = tx + 32 * j < T ? s[i][j] : -INFINITY;
      part[i] = fmaxf(part[i], s[i][j]);
    }
  }
  row_partials<true>(part, red_m, ty);
  cp_async_wait<0>();
  __syncthreads();
  float m[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = __fmul_rn(scale, row_total<true>(red_m, ty + 8 * i));
#pragma unroll
    for (int j = 0; j < J; ++j) s[i][j] = expf(fmaf(scale, s[i][j], -m[i]));  // e
  }
  nt<DP, 8, J, 8, 32>(dp, dos, ty, vs, tx);  // dp = do v^T
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    part[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) part[i] += s[i][j];
  }
  row_partials<false>(part, red_l, ty);
  __syncthreads();  // every thread is done with v: ds may take its buffer
  float l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l[i] = row_total<false>(red_l, ty + 8 * i);
    part2[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      s[i][j] = s[i][j] / l[i];  // p
      part2[i] = fmaf(s[i][j], dp[i][j], part2[i]);
    }
  }
  row_partials<false>(part2, red_pd, ty);
  __syncthreads();
  const int lane = threadIdx.x % 32, wx = (threadIdx.x / 32) % 4;
  const long nht = long(gridDim.z) * H * T;
  float* st = stats + (long(n) * H + h) * T;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ty + 8 * i;
    const float delta = row_total<false>(red_pd, row);
#pragma unroll
    for (int j = 0; j < J; ++j) dss[row * L::LDP + tx + 32 * j] = s[i][j] * (dp[i][j] - delta);
    if (wx == 0 && lane % 8 == 0 && q0 + row < T) {
      st[q0 + row] = m[i];
      st[nht + q0 + row] = l[i];
      st[2 * nht + q0 + row] = delta;
    }
  }
  __syncthreads();

  const int klen = min(TK, (T + 3) & ~3);
  const float mul[4] = {scale, scale, scale, scale};
#pragma unroll
  for (int slot = 0; slot < O::PER_THREAD; ++slot) {
    const int it = threadIdx.x + slot * THREADS;
    if (it >= O::COUNT) break;
    int oy, cg;
    O::at(it, oy, cg);
    float acc[4][4] = {};
    nn<4, L::LDP, L::LD>(acc, dss, oy, ks, 4 * cg, klen);  // dq = ds k
    store_tile(acc, mul, dq + long(n) * T * ldg + hd, ldg, q0, oy, 4 * cg, T, D);
  }
}

// K3, kernel 2: dk and dv of BK keys; the query chunks stream through a
// ring of two stages (q, do and their m, l, delta).
template <int DP>
__device__ __forceinline__ void load_chunk(float* stage, const float* qb, const float* db,
                                           const float* st, long nht, long ldq, long lddo,
                                           int c0, int T, int D) {
  using L = DkdvLayout<DP>;
  load_rows<DP, CHUNK>(stage, qb, ldq, c0, T, D);
  load_rows<DP, CHUNK>(stage + L::QROWS, db, lddo, c0, T, D);
  for (int id = threadIdx.x; id < 3 * CHUNK; id += THREADS) {
    const int which = id / CHUNK, r = id % CHUNK;
    const bool ok = c0 + r < T;
    cp_async4(stage + 2 * L::QROWS + id, ok ? st + which * nht + c0 + r : st, ok);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
attn_row_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         float* __restrict__ dk, float* __restrict__ dv,
                         const float* __restrict__ stats, int T, int H, int D, long ldq, long ldk,
                         long ldv, long lddo, long ldg, float scale) {
  using L = DkdvLayout<DP>;
  using O = OutTiles<DP>;
  constexpr int RM = L::RM;
  extern __shared__ __align__(16) float sm[];
  float *ks = sm, *vs = sm + L::V, *ps = sm + L::P, *dss = sm + L::DS;
  const int n = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * L::BK;
  const long hd = long(h) * D, nht = long(gridDim.z) * H * T;
  const float* qb = q + long(n) * T * ldq + hd;
  const float* db = dout + long(n) * T * lddo + hd;
  const float* st = stats + (long(n) * H + h) * T;
  const int chunks = (T + CHUNK - 1) / CHUNK;

  load_rows<DP, L::BK>(ks, k + long(n) * T * ldk + hd, ldk, k0, T, D);
  load_rows<DP, L::BK>(vs, v + long(n) * T * ldv + hd, ldv, k0, T, D);
  load_chunk<DP>(sm + L::STAGE0, qb, db, st, nht, ldq, lddo, 0, T, D);
  cp_async_commit();
  if (chunks > 1) load_chunk<DP>(sm + L::STAGE0 + L::STAGE, qb, db, st, nht, ldq, lddo, CHUNK, T, D);
  cp_async_commit();

  // s^T / dp^T tile of a thread: keys ty + 16i, queries tx + 16j; a warp
  // holds 4 keys x 8 queries
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  float acc_dv[O::PER_THREAD][RM][4] = {}, acc_dk[O::PER_THREAD][RM][4] = {};
  for (int c = 0; c < chunks; ++c) {
    float* stage = sm + L::STAGE0 + (c & 1) * L::STAGE;
    const float *qc = stage, *dc = stage + L::QROWS, *sc = stage + 2 * L::QROWS;
    cp_async_wait<1>();
    __syncthreads();
    float s[RM][4] = {}, dp[RM][4] = {};
    nt<DP, RM, 4, 16, 16>(s, ks, ty, qc, tx);  // s^T = k q^T
    nt<DP, RM, 4, 16, 16>(dp, vs, ty, dc, tx);  // dp^T = v do^T
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const bool ok = c * CHUNK + col < T;
      const float m = sc[col], l = sc[CHUNK + col], delta = sc[2 * CHUNK + col];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        // the dq kernel's p: exp(scale s - m), one FMA, over l
        const float p = ok ? expf(fmaf(scale, s[i][j], -m)) / l : 0.0f;
        ps[(ty + 16 * i) * L::LDP + col] = p;
        dss[(ty + 16 * i) * L::LDP + col] = ok ? p * (dp[i][j] - delta) : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int slot = 0; slot < O::PER_THREAD; ++slot) {
      const int it = threadIdx.x + slot * THREADS;
      if (it < O::COUNT) {
        int oy, cg;
        O::at(it, oy, cg);
        // the chunk's sums in fresh partials, added to the totals
        float pdv[RM][4] = {}, pdk[RM][4] = {};
        nn<RM, L::LDP, L::LD>(pdv, ps, oy, dc, 4 * cg, CHUNK);   // p^T do
        nn<RM, L::LDP, L::LD>(pdk, dss, oy, qc, 4 * cg, CHUNK);  // ds^T q
#pragma unroll
        for (int i = 0; i < RM; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc_dv[slot][i][c] += pdv[i][c];
            acc_dk[slot][i][c] += pdk[i][c];
          }
        }
      }
    }
    __syncthreads();  // the stage and p / ds are free again
    if (c + 2 < chunks)
      load_chunk<DP>(stage, qb, db, st, nht, ldq, lddo, (c + 2) * CHUNK, T, D);
    cp_async_commit();
  }
  float one[RM], mul[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) one[i] = 1.0f, mul[i] = scale;
#pragma unroll
  for (int slot = 0; slot < O::PER_THREAD; ++slot) {
    const int it = threadIdx.x + slot * THREADS;
    if (it >= O::COUNT) break;
    int oy, cg;
    O::at(it, oy, cg);
    store_tile(acc_dv[slot], one, dv + long(n) * T * ldg + hd, ldg, k0, oy, 4 * cg, T, D);
    store_tile(acc_dk[slot], mul, dk + long(n) * T * ldg + hd, ldg, k0, oy, 4 * cg, T, D);
  }
}

}  // namespace row32
}  // namespace lfm
