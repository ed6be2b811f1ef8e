// f32 K4, f32 K1 past T = 256 and f32 K3 past T = 256: the port of
// lfm_tpu/kernels/flash_attention.py::flash_attention (`_flash_kernel`), of
// ::attention_small (`_attn_small_kernel`) and of ::attention_small_bwd
// (`_attn_small_bwd_kernel`) at long sequences, for f32 models, redesigned
// for the H100's CUDA cores on the one-pass design of attention_row_f32.cuh
// (its loads and products are shared). f32 K4 is the forward of every f32
// attention past T = 1024 (an f32 DiT at 1024 px, T = 4096) and of the
// origin ADM's f32 attention at D = 128 past the gate; f32 K1 and K3 past T
// = 256 are the forward and backward of an f32 DiT whose patch grid has 256
// < T <= 1024 (512 px: T = 1024).
//
// Per (sample, head), with s = scale q k^T (scale = 1/sqrt(D)):
//   K4:  keys in blocks of BK (a divisor of T, at most 512); per block the
//        exact block max, m_new = max(m, block max), p = exp(s - m_new),
//        alpha = exp(m - m_new), l = alpha l + sum p, acc = alpha acc + p v;
//        o = acc / l at the end
//   K1:  the same kernel with one block of all T keys: alpha = exp(-inf -
//        m) = 0, so l = sum p and acc = p v with m the row's exact max, and
//        o = (p v) / l, K1's function at its rounding points
//   K3:  m = max_k s, e = exp(s - m), l = sum_k e, p = e / l,
//        dp = do v^T, delta = rowsum(dp * p), ds = p (dp - delta),
//        dq = scale ds k, dk = scale ds^T q, dv = p^T do
// all in f32 with the TPU kernels' rounding points (the exact max of each
// block or row, p before its sums, delta from p): only the order of the
// f32 sums differs. No TF32, no tensor core: an f32 model is f32
// throughout, so the products are f32 FMA.
//
// What bounds them on the H100: K4 at (1, 4096, 4, 128) moves 4 T H D * 4
// bytes (33.6 MB, 10 us) against 4 T^2 H D flops (34.4 GFLOP, 0.51 ms at
// the 67 TFLOP/s of the f32 units); K3 at (2, 1024, 16, 64) 7 T H D * 4
// bytes against 10 T^2 H D flops: both are bound by operations. On the CUDA
// cores the products are held back by their shared-memory loads as much as
// by the FMAs: a 16-byte shared load costs the SM ~2.7 cycles when each
// quarter-warp (8 lanes) reads at most 2 addresses and ~4.2 when it reads 4
// or more (tools/smem_probe.py), against 4 warp FMAs a cycle. The design:
//  - the scores of a whole key block (K4, up to 512 keys) or of a whole
//    row (K3's dq kernel, up to 1024 keys) stay in shared memory, so the
//    max is exact before any exp and QK^T runs once: K4 does 4 T^2 D
//    flops, not the 6 of a second sweep, and K3's dq kernel 6 T^2 D, not
//    the 10 of an online pass and a second sweep; with the dk/dv kernel of
//    attention_row_f32.cuh (8 T^2 D; it streams 64-query chunks, so it
//    takes any T) f32 K3 does 14 T^2 D in all, not 18;
//  - k and v stream through a ring of two cp.async stages of KS rows
//    (zero-filled past the block or T): stage g + 1 loads under the
//    product of stage g, and the first stage of the next product under the
//    reductions and the exp and division passes;
//  - register-blocked products whose most-loaded operand is one address a
//    quarter-warp: a thread's scores are RM rows x RN keys of a stage (rows
//    rg + 16 i, keys kg + TC j; a quarter-warp shares the key group), q and
//    k read as float4 along D from rows padded by 16 bytes; the products
//    with p or ds take 8 x 4 (K4) or 4 x 4 (K3's dq) output tiles (rows
//    oy + 8 i; a quarter-warp shares the row). A score row is padded by 16
//    bytes, so the 8 rows x 4 keys a warp writes fall on distinct banks.
// K4 (FBQ = 64 query rows a CTA): KS = 128 keys at DP 64 (4 x 8 scores a
// thread; p v in two groups of 128 threads, each taking half of every
// stage), 64 at DP 80 (4 x 4; p v on 160 threads), 32 at DP 128 (4 x 4 on
// 128 threads; p v on all 256); shared memory 216 / 194 / 196 KB, one CTA
// an SM: at (1, 4096, 4, 128) 256 CTAs, 1.94 waves on 132 SMs. K1 takes
// K4's instances at 256 < T <= 512 (BK = T <= 512); past 512 a row of 64 x
// 1024 scores would take 264 KB, so K1_BQ = 32 query rows a CTA hold 32 x
// 1024 (2 x 8 scores a thread at DP 64, 2 x 4 at DP 80, the dq kernel's
// tiles; p v in 4 x 4 tiles, two groups at DP 64 as K4), 206 / 182 KB: at
// (2, 1024, 16, 64) 1024 CTAs, 7.8 waves. K3's dq
// kernel (DBQ = 32 query rows): the row's scores in shared memory (32 x TK,
// TK = 512 or 1024), dp in registers (128 a thread at TK 1024), 2 x 8
// scores a thread at DP 64 (KS = 128), 2 x 4 at DP 80 (KS = 64); dq = ds k
// in two groups of 128 threads at DP 64, on 160 threads at DP 80; 215 / 193
// KB.
//
// The f32 sums: s and dp over D, one chain in order (the dk/dv kernel's s^T
// and dp^T are the dq kernel's s and dp bit for bit, and so is its p); l,
// delta and a block's sum of p: each thread sums its keys (kg + TC j, in
// order), the 4 quarter-warps of a warp a tree (xor 8, 16), the NW warps of
// a row in order. p v (K4, K1) and dq sum each stage's keys (each half stage,
// in two groups, at DP 64) in a fresh partial added to the total in order;
// K4 and K1 at DP 64 instead keep two accumulators, one chain over each
// group's half of every stage, added at the end. Against float64 these shorter
// chains measured closer than one chain over the keys (the old kernels'
// and the plain version's order), and so further from the plain version.
// K4 adds alpha l + sum p and alpha acc + pv as one FMA each. The max is
// taken of the unscaled s and scaled once (rounding is monotonic), and scale
// s - m is one FMA, as in attention_row_f32.cuh.
#pragma once

#include "attention.cuh"
#include "attention_row_f32.cuh"

namespace lfm {
namespace long32 {

using row32::THREADS;

constexpr int FBQ = 64;      // query rows of a K4 CTA (and K1's up to T = 512)
constexpr int BK_MAX = 512;  // K4's largest key block (flash_attention's default block_k)
constexpr int DBQ = 32;      // query rows of a K3 dq CTA
constexpr int K1_BQ = 32;    // query rows of a K1 CTA past T = 512
constexpr int MAX_T = 1024;  // K1's and K3's gate (_small_shape_ok)

// The scores of a thread: rows rg + 16 i, keys kg + TC j of a stage (TC key
// groups). A warp holds 8 row groups x 4 key groups and a quarter-warp (8
// lanes) one key group, so each k load of a quarter-warp reads one address
// (the cheaper load, above): a thread loads k RN times a step against q RM
// times.
__device__ __forceinline__ void s_thread(int& rg, int& kg) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  rg = (warp % 2) * 8 + lane % 8;
  kg = (warp / 2) * 4 + lane / 8;
}

// Reduce v (one value per row rg + 16 i) over the key groups of each row:
// the 4 quarter-warps by shuffle (xor 8, then 16), then each warp's partial
// to red[warp / 2][bq]; after a __syncthreads, row_total combines the NW
// warps' partials in order (every thread gets the same bits).
template <bool MAX, int RM>
__device__ __forceinline__ void row_partials(float (&v)[RM], float* red, int rg, int bq) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    v[i] = row32::combine<MAX>(v[i], __shfl_xor_sync(0xffffffffu, v[i], 8));
    v[i] = row32::combine<MAX>(v[i], __shfl_xor_sync(0xffffffffu, v[i], 16));
  }
  if (threadIdx.x % 32 < 8) {
#pragma unroll
    for (int i = 0; i < RM; ++i) red[(threadIdx.x / 64) * bq + rg + 16 * i] = v[i];
  }
}
template <bool MAX, int NW>
__device__ __forceinline__ float row_total(const float* red, int row, int bq) {
  float t = red[row];
#pragma unroll
  for (int w = 1; w < NW; ++w) t = row32::combine<MAX>(t, red[w * bq + row]);
  return t;
}

// K4 and K1: q (BQ rows), the block's scores (BQ x KCAP, then p), the ring,
// two reductions
template <int DP, int BQ, int KCAP>
struct FlashLayout {
  static constexpr int KS = DP <= 64 ? 128 : DP <= 80 ? 64 : 32;  // keys of a ring stage
  static constexpr int RM = BQ / 16, RN = DP <= 64 ? 8 : 4;      // scores of a thread
  static constexpr int TC = KS / RN;                             // key groups: 16, 16, 8
  static constexpr int S_THREADS = 16 * TC;                      // threads forming scores
  static constexpr int NW = TC / 4;                              // warps across a score row
  // p v: RMO x 4 tiles (rows oy + 8 i); where two groups of 128 threads
  // cover the tiles (DP 64), each takes one half of a stage's keys
  static constexpr int RG = 8, RMO = BQ / RG;
  static constexpr int SPLIT = 2 * row32::OutTiles<DP, RG>::COUNT <= THREADS ? 2 : 1;
  static constexpr int LD = DP + 4, LDS = KCAP + 4;
  static constexpr int STAGE = KS * LD;
  static constexpr int S = BQ * LD, RING = S + BQ * LDS, RED = RING + 2 * STAGE;
  static constexpr size_t BYTES = 4 * size_t(RED + 2 * NW * BQ);
  static_assert(KCAP % KS == 0, "a block's stages end inside the score rows");
};

// One CTA per BQ query rows of one (sample, head); BK divides T, BK <= KCAP.
// K4 runs <DP, FBQ, BK_MAX>; K1 its whole row as one block of BK = T keys:
// <DP, FBQ, BK_MAX> at T <= 512, <DP, K1_BQ, MAX_T> past it.
template <int DP, int BQ, int KCAP>
__global__ void __launch_bounds__(THREADS, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int T, int D, int BK,
                 long ldq, long ldk, long ldv, long ldo, float scale) {
  using L = FlashLayout<DP, BQ, KCAP>;
  using O = row32::OutTiles<DP, L::RG>;
  constexpr int RM = L::RM, RN = L::RN, TC = L::TC, KS = L::KS, NW = L::NW;
  constexpr int RMO = L::RMO, RG = L::RG, HALF = KS / L::SPLIT;
  extern __shared__ __align__(16) float sm[];
  float *qs = sm, *ss = sm + L::S, *ring = sm + L::RING;
  float *red_m = sm + L::RED, *red_l = red_m + NW * BQ;
  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const long hd = long(h) * D;
  const float* kb = k + long(n) * T * ldk + hd;
  const float* vb = v + long(n) * T * ldv + hd;
  // the ring's jobs, in order: per key block, its nst stages of k, then of v
  const int nst = (BK + KS - 1) / KS, per_block = 2 * nst, jobs = (T / BK) * per_block;
  auto issue = [&](int g) {
    if (g < jobs) {
      const int b0 = (g / per_block) * BK, r = g % per_block;
      float* dst = ring + (g & 1) * L::STAGE;
      const int k0 = b0 + (r % nst) * KS;
      if (r < nst) row32::load_rows<DP, KS>(dst, kb, ldk, k0, b0 + BK, D);
      else row32::load_rows<DP, KS>(dst, vb, ldv, k0, b0 + BK, D);
    }
    cp_async_commit();
  };
  row32::load_rows<DP, BQ>(qs, q + long(n) * T * ldq + hd, ldq, q0, T, D);
  cp_async_commit();
  issue(0);

  int rg, kg;
  s_thread(rg, kg);
  const bool s_active = int(threadIdx.x) < L::S_THREADS;  // warp-uniform
  float m_s[RM];  // the running max of this thread's score rows
#pragma unroll
  for (int i = 0; i < RM; ++i) m_s[i] = -INFINITY;
  // this thread's p v tile (group grp's part of each stage), its sums and
  // the running m and l of its rows
  const int grp = threadIdx.x / O::COUNT, it = threadIdx.x % O::COUNT;
  const bool o_active = grp < L::SPLIT;
  int oy, cg;
  O::at(it, oy, cg);
  float acc[RMO][4], m_o[RMO], l_o[RMO];
#pragma unroll
  for (int i = 0; i < RMO; ++i) {
    m_o[i] = -INFINITY;
    l_o[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  }

  int g = 0;
  for (int b0 = 0; b0 < T; b0 += BK) {
    // s = q k^T of the block into ss, stage by stage; keys past it -inf
    float part[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) part[i] = -INFINITY;
    for (int st = 0; st < nst; ++st, ++g) {
      cp_async_wait<0>();
      __syncthreads();  // stage g has landed; every thread is done with stage g - 1
      issue(g + 1);
      if (s_active) {
        const float* ks = ring + (g & 1) * L::STAGE;
        float s[RM][RN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) s[i][j] = 0.0f;
        row32::nt<DP, RM, RN, 16, TC, 4>(s, qs, rg, ks, kg);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int key = st * KS + kg + TC * j;
            const float sv = key < BK ? s[i][j] : -INFINITY;
            ss[(rg + 16 * i) * L::LDS + key] = sv;
            part[i] = fmaxf(part[i], sv);
          }
        }
      }
    }
    if (s_active) row_partials<true>(part, red_m, rg, BQ);
    __syncthreads();
    // m_new = max(m, block max); p = exp(s - m_new) in place; l's partials
    if (s_active) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float m_new =
            fmaxf(m_s[i], __fmul_rn(scale, row_total<true, NW>(red_m, rg + 16 * i, BQ)));
        float* srow = ss + (rg + 16 * i) * L::LDS + kg;
        part[i] = 0.0f;
#pragma unroll 4
        for (int c = 0; c < nst * KS; c += TC) {
          const float e = expf(fmaf(scale, srow[c], -m_new));
          srow[c] = e;
          part[i] += e;
        }
        m_s[i] = m_new;
      }
      row_partials<false>(part, red_l, rg, BQ);
    }
    float alpha[RMO];
#pragma unroll
    for (int i = 0; i < RMO; ++i) {
      const float m_new = fmaxf(
          m_o[i], __fmul_rn(scale, row_total<true, NW>(red_m, oy + RG * i, BQ)));
      alpha[i] = expf(m_o[i] - m_new);  // 0 at the first block
      m_o[i] = m_new;
    }
    // pv = p v of the block (this group's keys), in key order
    float pv[RMO][4];
#pragma unroll
    for (int i = 0; i < RMO; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) pv[i][c] = 0.0f;
    for (int st = 0; st < nst; ++st, ++g) {
      cp_async_wait<0>();
      __syncthreads();  // and every p and red_l entry is written
      issue(g + 1);
      const int k0 = st * KS + grp * HALF;
      const int klen = min(HALF, (BK - k0 + 3) & ~3);
      if (!o_active || klen <= 0) continue;
      const float* vs = ring + (g & 1) * L::STAGE + grp * HALF * L::LD;
      if constexpr (L::SPLIT == 2) {
        row32::nn<RMO, L::LDS, L::LD, RG, 4>(pv, ss + k0, oy, vs, 4 * cg, klen);
      } else {  // the stage's sum in a fresh partial, added to the block's
        float sp[RMO][4];
#pragma unroll
        for (int i = 0; i < RMO; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) sp[i][c] = 0.0f;
        row32::nn<RMO, L::LDS, L::LD, RG, 4>(sp, ss + k0, oy, vs, 4 * cg, klen);
#pragma unroll
        for (int i = 0; i < RMO; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) pv[i][c] += sp[i][c];
      }
    }
    // l = alpha l + sum p, acc = alpha acc + p v
#pragma unroll
    for (int i = 0; i < RMO; ++i) {
      const float a = alpha[i];
      l_o[i] = fmaf(a, l_o[i], row_total<false, NW>(red_l, oy + RG * i, BQ));
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a, acc[i][c], pv[i][c]);
    }
  }

  // o = acc / l; at DP 64 group 1's sums are added to group 0's first
  if constexpr (L::SPLIT == 2) {
    __syncthreads();  // every thread is done with the ring
    float* other = ring + it * RMO * 4;
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < RMO; ++i)
        *reinterpret_cast<float4*>(other + 4 * i) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < RMO; ++i) {
        const float4 b = *reinterpret_cast<const float4*>(other + 4 * i);
        acc[i][0] += b.x, acc[i][1] += b.y, acc[i][2] += b.z, acc[i][3] += b.w;
      }
    }
  }
  if (grp != 0 || 4 * cg >= D) return;
#pragma unroll
  for (int i = 0; i < RMO; ++i) {
    const int r = q0 + oy + RG * i;
    const float l = l_o[i];
    if (r < T)
      *reinterpret_cast<float4*>(o + (long(n) * T + r) * ldo + hd + 4 * cg) =
          make_float4(acc[i][0] / l, acc[i][1] / l, acc[i][2] / l, acc[i][3] / l);
  }
}

// one instance of flash_f32_kernel on `s`: BK divides T, BK <= KCAP
template <int DP, int BQ, int KCAP>
cudaError_t launch_flash(const float* q, const float* k, const float* v, float* o, int N, int T,
                         int H, int D, int BK, long ldq, long ldk, long ldv, long ldo,
                         cudaStream_t s) {
  using L = FlashLayout<DP, BQ, KCAP>;
  static_assert(L::BYTES <= size_t(ATT_MAX_SMEM), "flash_f32_kernel's tiles exceed shared memory");
  auto kernel = flash_f32_kernel<DP, BQ, KCAP>;
  const int bytes = int(L::BYTES);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, H, N);
  kernel<<<grid, THREADS, bytes, s>>>(q, k, v, o, T, D, BK, ldq, ldk, ldv, ldo,
                                      1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

// K3's dq kernel past T = 256: q and do (DBQ rows), the row's scores (DBQ x
// TK, then e, p, ds), the ring, three reductions
template <int DP, int TK>
struct LongDqLayout {
  static constexpr int KS = DP <= 64 ? 128 : 64;  // keys of a ring stage
  static constexpr int NST = TK / KS;
  static constexpr int RM = DBQ / 16, RN = KS / 16, TC = 16, NW = 4;
  static constexpr int LD = DP + 4, LDS = TK + 4;
  static constexpr int STAGE = KS * LD;
  static constexpr int DO = DBQ * LD, S = 2 * DBQ * LD, RING = S + DBQ * LDS;
  static constexpr int RED = RING + 2 * STAGE;
  static constexpr size_t BYTES = 4 * size_t(RED + 3 * NW * DBQ);
  // dq = ds k: 4 x 4 tiles (rows oy + 8 i); at DP 64 two groups of 128
  // threads each take one half of a stage's keys, at DP 80 160 threads all
  static constexpr int SPLIT = 2 * row32::OutTiles<DP, 8>::COUNT <= THREADS ? 2 : 1;
};

// K3, kernel 1 past T = 256: dq and the row statistics (m, l, delta) of 32
// query rows over the whole row of keys, T <= TK (512 or 1024). Kernel 2 is
// attention_row_f32.cuh's attn_row_bwd_dkdv_kernel.
template <int DP, int TK>
__global__ void __launch_bounds__(THREADS, 1)
attn_long_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ stats, int T, int H, int D,
                        long ldq, long ldk, long ldv, long lddo, long ldg, float scale) {
  using L = LongDqLayout<DP, TK>;
  using O = row32::OutTiles<DP, 8>;
  constexpr int RM = L::RM, RN = L::RN, TC = L::TC, KS = L::KS, NW = L::NW;
  extern __shared__ __align__(16) float sm[];
  float *qs = sm, *dos = sm + L::DO, *ss = sm + L::S, *ring = sm + L::RING;
  float *red_m = sm + L::RED, *red_l = red_m + NW * DBQ, *red_pd = red_l + NW * DBQ;
  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * DBQ;
  const long hd = long(h) * D;
  const float* kb = k + long(n) * T * ldk + hd;
  const float* vb = v + long(n) * T * ldv + hd;
  // the ring's jobs, in order: the nst stages of k (s), of v (dp), of k (dq)
  const int nst = (T + KS - 1) / KS, jobs = 3 * nst;
  auto issue = [&](int g) {
    if (g < jobs) {
      float* dst = ring + (g & 1) * L::STAGE;
      const int k0 = (g % nst) * KS;
      if (g / nst == 1) row32::load_rows<DP, KS>(dst, vb, ldv, k0, T, D);
      else row32::load_rows<DP, KS>(dst, kb, ldk, k0, T, D);
    }
    cp_async_commit();
  };
  row32::load_rows<DP, DBQ>(qs, q + long(n) * T * ldq + hd, ldq, q0, T, D);
  row32::load_rows<DP, DBQ>(dos, dout + long(n) * T * lddo + hd, lddo, q0, T, D);
  cp_async_commit();
  issue(0);

  int rg, kg;
  s_thread(rg, kg);
  // s = q k^T of the whole row into ss; keys past T -inf
  float part[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) part[i] = -INFINITY;
  int g = 0;
  for (int st = 0; st < nst; ++st, ++g) {
    cp_async_wait<0>();
    __syncthreads();  // stage g has landed; every thread is done with stage g - 1
    issue(g + 1);
    const float* ks = ring + (g & 1) * L::STAGE;
    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.0f;
    row32::nt<DP, RM, RN, 16, TC>(s, qs, rg, ks, kg);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int key = st * KS + kg + TC * j;
        const float sv = key < T ? s[i][j] : -INFINITY;
        ss[(rg + 16 * i) * L::LDS + key] = sv;
        part[i] = fmaxf(part[i], sv);
      }
    }
  }
  row_partials<true>(part, red_m, rg, DBQ);
  __syncthreads();
  // m, e = exp(s - m) in place, l
  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = __fmul_rn(scale, row_total<true, NW>(red_m, rg + 16 * i, DBQ));
    float* srow = ss + (rg + 16 * i) * L::LDS + kg;
    part[i] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < nst * KS; c += TC) {
      const float e = expf(fmaf(scale, srow[c], -m[i]));
      srow[c] = e;
      part[i] += e;
    }
  }
  row_partials<false>(part, red_l, rg, DBQ);
  __syncthreads();
  // p = e / l in place, while the first stage of v loads
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    l[i] = row_total<false, NW>(red_l, rg + 16 * i, DBQ);
    part[i] = 0.0f;
    float* srow = ss + (rg + 16 * i) * L::LDS + kg;
#pragma unroll 4
    for (int c = 0; c < nst * KS; c += TC) srow[c] = srow[c] / l[i];
  }
  // dp = do v^T into registers, stage by stage; delta's partials
  float dp[L::NST][RM][RN];
#pragma unroll
  for (int st = 0; st < L::NST; ++st) {
    if (st < nst) {
      cp_async_wait<0>();
      __syncthreads();
      issue(g + 1);
      const float* vs = ring + (g & 1) * L::STAGE;
      ++g;
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) dp[st][i][j] = 0.0f;
      row32::nt<DP, RM, RN, 16, TC>(dp[st], dos, rg, vs, kg);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const float p = ss[(rg + 16 * i) * L::LDS + st * KS + kg + TC * j];
          part[i] = fmaf(p, dp[st][i][j], part[i]);
        }
      }
    }
  }
  row_partials<false>(part, red_pd, rg, DBQ);
  __syncthreads();
  // ds = p (dp - delta) in place, and the row statistics for kernel 2
  float delta[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) delta[i] = row_total<false, NW>(red_pd, rg + 16 * i, DBQ);
#pragma unroll
  for (int st = 0; st < L::NST; ++st) {
    if (st < nst) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          float& p = ss[(rg + 16 * i) * L::LDS + st * KS + kg + TC * j];
          p = p * (dp[st][i][j] - delta[i]);
        }
      }
    }
  }
  if (kg == 0) {
    const long nht = long(gridDim.z) * H * T;
    float* st = stats + (long(n) * H + h) * T;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = q0 + rg + 16 * i;
      if (r < T) {
        st[r] = m[i];
        st[nht + r] = l[i];
        st[2 * nht + r] = delta[i];
      }
    }
  }
  // dq = scale ds k: group grp takes half of each stage's keys (all of them
  // at DP 80), sums it in a fresh partial and adds that to its total; the
  // groups' totals are added at the end
  const int grp = threadIdx.x / O::COUNT, it = threadIdx.x % O::COUNT;
  const bool c_active = grp < L::SPLIT;  // warp-uniform
  constexpr int HALF = KS / L::SPLIT;
  int oy, cg;
  O::at(it, oy, cg);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  for (int st = 0; st < nst; ++st, ++g) {
    cp_async_wait<0>();
    __syncthreads();  // and every ds is written
    issue(g + 1);
    const int k0 = st * KS + grp * HALF;
    const int klen = min(HALF, (T - k0 + 3) & ~3);
    if (!c_active || klen <= 0) continue;
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[i][c] = 0.0f;
    const float* ks = ring + (g & 1) * L::STAGE + grp * HALF * L::LD;
    row32::nn<4, L::LDS, L::LD, 8>(part, ss + k0, oy, ks, 4 * cg, klen);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] += part[i][c];
  }
  if constexpr (L::SPLIT == 2) {
    __syncthreads();  // every thread is done with the ring
    float* other = ring + it * 16;
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(other + 4 * i) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 b = *reinterpret_cast<const float4*>(other + 4 * i);
        acc[i][0] += b.x, acc[i][1] += b.y, acc[i][2] += b.z, acc[i][3] += b.w;
      }
    }
  }
  if (grp != 0) return;
  const float mul[4] = {scale, scale, scale, scale};
  row32::store_tile<8>(acc, mul, dq + long(n) * T * ldg + hd, ldg, q0, oy, 4 * cg, T, D);
}

}  // namespace long32
}  // namespace lfm
