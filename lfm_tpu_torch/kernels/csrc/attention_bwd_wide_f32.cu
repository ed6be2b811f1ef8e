// f32 K3 at the origin ADM's wide heads, D = 128 (celeb256_adm, church_adm)
// and 256 (celeb512_adm): the port of lfm_tpu/kernels/flash_attention.py::
// attention_small_bwd (`_attn_small_bwd_kernel`) in f32 over the whole
// small-T gate (T <= 1024). The origin ADM's attention is an f32 island, so
// its training step runs this once per attention layer: celeb256_adm at (N,
// 16, 4, 128), celeb512_adm at (N, 64, 4, 128) and (N, 16, 4, 256), and an
// --attn_resolutions override up to T = 1024. Compiled apart from K3's
// other sources so that they build in parallel.
//
// Per (sample, head), with s = scale q k^T (scale = 1/sqrt(D)):
//   m = max_k s, e = exp(s - m), l = sum_k e, p = e / l,
//   dv = p^T do, dp = do v^T, delta = rowsum(dp * p), ds = p (dp - delta),
//   dq = scale ds k, dk = scale ds^T q
// all in f32 (f32 FMA products, no TF32, no tensor core, the exact row max),
// as the kernels of attention_row_f32.cuh and attention_long_f32.cuh form
// them at D <= 80: only the order of the f32 sums differs from the TPU
// kernel's. No atomics: every sum has a fixed order. Two kernels, the
// FlashAttention-2 split:
//  - attn_wide_bwd_dq_kernel: BQ = 16 query rows of one (sample, head) a
//    CTA. k and v stream through a ring of two cp.async stages of KS keys
//    (64 at D = 128, 32 at D = 256; zero-filled past T) in the order k0, v0,
//    k1, v1, ..., then k0, k1, ... again for dq, so each stage loads under
//    the product of the one before. The whole row of s and of dp (16 x T,
//    T rounded up to KS) stays in shared memory: the exact max before any
//    exp, then e, l, p, delta and ds = p (dp - delta) in place, and the
//    row statistics m, l, delta to flash_attention.bwd_stats_scratch (3 N
//    H T floats). dq = ds k, each thread 4 columns of RMO rows.
//    A thread's scores are one row (rg) x KS / 16 keys (kg + 16 j) a stage,
//    q and k read as float4 along D from rows padded by 16 bytes; a
//    quarter-warp shares the key group, so its k loads read one address.
//    Shared memory at T = 1024: 216,832 bytes at D = 128 and 232,192 at D =
//    256 (of the 232,448 a CTA may have); at T = 16, 93,952 / 105,216.
//  - attn_wide_bwd_dkdv_kernel: BK keys a CTA (64 at D = 128, 32 at D =
//    256), its k and v held in shared memory; the queries stream in chunks
//    of CH = 32 (q, do and their m, l, delta) through a ring of two stages.
//    Per chunk s^T and dp^T (keys ty + 16 i x queries tx + 16 j a thread),
//    p = exp(scale s - m) / l formed as the dq kernel forms it (the same
//    FMA chain over D, so the same bits), ds, then dv += p^T do and dk +=
//    ds^T q, each thread 4 columns of 8 key rows of both. 154,368 / 209,664
//    bytes.
// What bounds it: 7 T H D * 4 bytes against 10 T^2 H D flops (the plain
// version's count; the dk/dv kernel recomputes s and dp, 14 T^2 D in all).
// At the presets' T = 16 and 64 the bytes set the bound: at (112, 16, 4,
// 128) 25.7 MB, 7.7 us at 3.35 TB/s, against 0.15 GFLOP. Past T ~ 200 the
// f32 units do. This is the simple kernel: no register blocking past one
// query row in the dq kernel's scores, and keys past T in a stage computed
// and dropped.
//
// The f32 sums: s and dp over D, one chain in order in both kernels; l,
// delta: each thread its keys in order, the quarter-warps a tree (xor 8,
// 16), the 4 warps of a row in order; dq one chain over the keys; dk and dv
// one chain over the queries. m is the max of the unscaled s, scaled once,
// and scale s - m one FMA, as in attention_row_f32.cuh.
#include "attention.cuh"
#include "attention_long_f32.cuh"

namespace lfm {
namespace wide32 {

using row32::THREADS;
constexpr int BQ = 16;  // query rows of a dq CTA
constexpr int CH = 32;  // query rows of a dk/dv chunk
constexpr int NW = 4;   // warps across a score row of the dq kernel

// acc[i][0..3] += sum_k A[r0 + RS i][k] B[k][c..c+3], k in order over
// [0, klen), klen % 4 == 0; A's row stride lda is a run-time value
template <int RM, int RS, int LDB>
__device__ __forceinline__ void nn_rows(float (&acc)[RM][4], const float* A, int lda, int r0,
                                        const float* B, int c, int klen) {
#pragma unroll 2
  for (int k = 0; k < klen; k += 4) {
    float4 a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (r0 + RS * i) * lda + k);
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

// The dq kernel: q, do (BQ rows each), the ring, 3 reductions, then the
// rows of s (then e, p, ds) and of dp, each BQ x lds floats, lds = T
// rounded up to KS, plus 4
template <int DP>
struct WideDq {
  static constexpr int KS = DP <= 128 ? 64 : 32;
  static constexpr int RN = KS / 16;  // scores of a thread a stage
  static constexpr int LD = DP + 4;
  static constexpr int STAGE = KS * LD;
  static constexpr int CG = DP / 4, RS = THREADS / CG, RMO = BQ / RS;  // dq tiles
  static constexpr int DO = BQ * LD, RING = 2 * BQ * LD, RED = RING + 2 * STAGE;
  static constexpr int S = RED + 3 * NW * BQ;
  static __host__ __device__ int lds(int T) { return (T + KS - 1) / KS * KS + 4; }
  static size_t bytes(int T) { return 4 * (size_t(S) + 2 * size_t(BQ) * lds(T)); }
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
attn_wide_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ stats, int T, int H, int D,
                        long ldq, long ldk, long ldv, long lddo, long ldg, float scale) {
  using L = WideDq<DP>;
  constexpr int KS = L::KS, RN = L::RN;
  extern __shared__ __align__(16) float sm[];
  const int nst = (T + KS - 1) / KS, lds = L::lds(T);
  float *qs = sm, *dos = sm + L::DO, *ring = sm + L::RING;
  float *red_m = sm + L::RED, *red_l = red_m + NW * BQ, *red_pd = red_l + NW * BQ;
  float *ss = sm + L::S, *dps = ss + BQ * lds;
  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const long hd = long(h) * D;
  const float* kb = k + long(n) * T * ldk + hd;
  const float* vb = v + long(n) * T * ldv + hd;
  // the ring's jobs, in order: k0, v0, k1, v1, ... (s and dp), then k0, k1,
  // ... (dq)
  const int jobs = 3 * nst;
  auto issue = [&](int g) {
    if (g < jobs) {
      float* dst = ring + (g & 1) * L::STAGE;
      const bool is_v = g < 2 * nst && (g & 1);
      const int st = g < 2 * nst ? g / 2 : g - 2 * nst;
      if (is_v) row32::load_rows<DP, KS>(dst, vb, ldv, st * KS, T, D);
      else row32::load_rows<DP, KS>(dst, kb, ldk, st * KS, T, D);
    }
    cp_async_commit();
  };
  row32::load_rows<DP, BQ>(qs, q + long(n) * T * ldq + hd, ldq, q0, T, D);
  row32::load_rows<DP, BQ>(dos, dout + long(n) * T * lddo + hd, lddo, q0, T, D);
  cp_async_commit();
  issue(0);

  int rg, kg;
  long32::s_thread(rg, kg);
  float* srow = ss + rg * lds;
  float* dprow = dps + rg * lds;
  // s = q k^T and dp = do v^T of the whole row; keys past T: s = -inf
  float part[1] = {-INFINITY};
  int g = 0;
  for (int st = 0; st < nst; ++st) {
#pragma unroll
    for (int which = 0; which < 2; ++which, ++g) {
      cp_async_wait<0>();
      __syncthreads();  // stage g has landed; every thread is done with stage g - 1
      issue(g + 1);
      const float* stage = ring + (g & 1) * L::STAGE;
      float acc[1][RN];
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[0][j] = 0.0f;
      row32::nt<DP, 1, RN, 16, 16>(acc, which ? dos : qs, rg, stage, kg);
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int key = st * KS + kg + 16 * j;
        if (which) {
          dprow[key] = acc[0][j];
        } else {
          const float sv = key < T ? acc[0][j] : -INFINITY;
          srow[key] = sv;
          part[0] = fmaxf(part[0], sv);
        }
      }
    }
  }
  // each thread reads back only the keys it wrote (kg + 16 c)
  const int keys = nst * KS;
  long32::row_partials<true, 1>(part, red_m, rg, BQ);
  __syncthreads();
  const float m = __fmul_rn(scale, long32::row_total<true, NW>(red_m, rg, BQ));
  part[0] = 0.0f;
  for (int c = kg; c < keys; c += 16) {
    const float e = expf(fmaf(scale, srow[c], -m));
    srow[c] = e;
    part[0] += e;
  }
  long32::row_partials<false, 1>(part, red_l, rg, BQ);
  __syncthreads();
  const float l = long32::row_total<false, NW>(red_l, rg, BQ);
  part[0] = 0.0f;
  for (int c = kg; c < keys; c += 16) {
    const float p = srow[c] / l;
    srow[c] = p;
    part[0] = fmaf(p, dprow[c], part[0]);
  }
  long32::row_partials<false, 1>(part, red_pd, rg, BQ);
  __syncthreads();
  const float delta = long32::row_total<false, NW>(red_pd, rg, BQ);
  for (int c = kg; c < keys; c += 16) srow[c] = srow[c] * (dprow[c] - delta);
  if (kg == 0 && q0 + rg < T) {
    const long nht = long(gridDim.z) * H * T;
    float* stp = stats + (long(n) * H + h) * T + q0 + rg;
    stp[0] = m;
    stp[nht] = l;
    stp[2 * nht] = delta;
  }

  // dq = scale ds k: columns 4 cg .. 4 cg + 3 of rows oy + RS i, one chain
  // over the keys
  const int cg = threadIdx.x % L::CG, oy = threadIdx.x / L::CG;
  float acc[L::RMO][4];
#pragma unroll
  for (int i = 0; i < L::RMO; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  for (int st = 0; st < nst; ++st, ++g) {
    cp_async_wait<0>();
    __syncthreads();  // the stage has landed, and every ds is written
    issue(g + 1);
    const int k0 = st * KS;
    const int klen = min(KS, (T - k0 + 3) & ~3);
    nn_rows<L::RMO, L::RS, L::LD>(acc, ss + k0, lds, oy, ring + (g & 1) * L::STAGE, 4 * cg,
                                  klen);
  }
  float mul[L::RMO];
#pragma unroll
  for (int i = 0; i < L::RMO; ++i) mul[i] = scale;
  row32::store_tile<L::RS>(acc, mul, dq + long(n) * T * ldg + hd, ldg, q0, oy, 4 * cg, T, D);
}

// The dk/dv kernel: k, v (BK rows each), two stages of a query chunk (q,
// do, then m, l, delta), p and ds (BK x CH each)
template <int DP>
struct WideDkdv {
  static constexpr int BK = DP <= 128 ? 64 : 32;
  static constexpr int RM = BK / 16, RN = CH / 16;  // s^T of a thread
  static constexpr int LD = DP + 4, LDP = CH + 4;
  static constexpr int CG = DP / 4, RS = THREADS / CG, RMO = BK / RS;  // dk / dv tiles
  static constexpr int KROWS = BK * LD, QROWS = CH * LD;
  static constexpr int V = KROWS, STAGE0 = 2 * KROWS;
  static constexpr int STAGE = 2 * QROWS + 3 * CH;
  static constexpr int P = STAGE0 + 2 * STAGE, DS = P + BK * LDP;
  static constexpr size_t BYTES = 4 * size_t(DS + BK * LDP);
};

template <int DP>
__device__ __forceinline__ void load_chunk(float* stage, const float* qb, const float* db,
                                           const float* st, long nht, long ldq, long lddo,
                                           int c0, int T, int D) {
  using L = WideDkdv<DP>;
  row32::load_rows<DP, CH>(stage, qb, ldq, c0, T, D);
  row32::load_rows<DP, CH>(stage + L::QROWS, db, lddo, c0, T, D);
  for (int id = threadIdx.x; id < 3 * CH; id += THREADS) {
    const int which = id / CH, r = id % CH;
    const bool ok = c0 + r < T;
    row32::cp_async4(stage + 2 * L::QROWS + id, ok ? st + which * nht + c0 + r : st, ok);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
attn_wide_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          float* __restrict__ dk, float* __restrict__ dv,
                          const float* __restrict__ stats, int T, int H, int D, long ldq,
                          long ldk, long ldv, long lddo, long ldg, float scale) {
  using L = WideDkdv<DP>;
  constexpr int RM = L::RM, RN = L::RN, RMO = L::RMO;
  extern __shared__ __align__(16) float sm[];
  float *ks = sm, *vs = sm + L::V, *ps = sm + L::P, *dss = sm + L::DS;
  const int n = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * L::BK;
  const long hd = long(h) * D, nht = long(gridDim.z) * H * T;
  const float* qb = q + long(n) * T * ldq + hd;
  const float* db = dout + long(n) * T * lddo + hd;
  const float* st = stats + (long(n) * H + h) * T;
  const int chunks = (T + CH - 1) / CH;

  row32::load_rows<DP, L::BK>(ks, k + long(n) * T * ldk + hd, ldk, k0, T, D);
  row32::load_rows<DP, L::BK>(vs, v + long(n) * T * ldv + hd, ldv, k0, T, D);
  load_chunk<DP>(sm + L::STAGE0, qb, db, st, nht, ldq, lddo, 0, T, D);
  cp_async_commit();
  if (chunks > 1) load_chunk<DP>(sm + L::STAGE0 + L::STAGE, qb, db, st, nht, ldq, lddo, CH, T, D);
  cp_async_commit();

  // s^T / dp^T of a thread: keys ty + 16 i, queries tx + 16 j; a warp holds
  // 4 keys x 8 queries, a quarter-warp one key
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  const int cg = threadIdx.x % L::CG, oy = threadIdx.x / L::CG;
  float acc_dv[RMO][4], acc_dk[RMO][4];
#pragma unroll
  for (int i = 0; i < RMO; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_dv[i][c] = acc_dk[i][c] = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    float* stage = sm + L::STAGE0 + (c & 1) * L::STAGE;
    const float *qc = stage, *dc = stage + L::QROWS, *sc = stage + 2 * L::QROWS;
    cp_async_wait<1>();
    __syncthreads();
    float s[RM][RN], dp[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = dp[i][j] = 0.0f;
    row32::nt<DP, RM, RN, 16, 16>(s, ks, ty, qc, tx);   // s^T = k q^T
    row32::nt<DP, RM, RN, 16, 16>(dp, vs, ty, dc, tx);  // dp^T = v do^T
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = tx + 16 * j;
      const bool ok = c * CH + col < T;
      const float m = sc[col], l = sc[CH + col], delta = sc[2 * CH + col];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        // the dq kernel's p: exp(scale s - m), one FMA, over l
        const float p = ok ? expf(fmaf(scale, s[i][j], -m)) / l : 0.0f;
        ps[(ty + 16 * i) * L::LDP + col] = p;
        dss[(ty + 16 * i) * L::LDP + col] = ok ? p * (dp[i][j] - delta) : 0.0f;
      }
    }
    __syncthreads();
    nn_rows<RMO, L::RS, L::LD>(acc_dv, ps, L::LDP, oy, dc, 4 * cg, CH);   // p^T do
    nn_rows<RMO, L::RS, L::LD>(acc_dk, dss, L::LDP, oy, qc, 4 * cg, CH);  // ds^T q
    __syncthreads();  // the stage and p / ds are free again
    if (c + 2 < chunks) load_chunk<DP>(stage, qb, db, st, nht, ldq, lddo, (c + 2) * CH, T, D);
    cp_async_commit();
  }
  float one[RMO], mul[RMO];
#pragma unroll
  for (int i = 0; i < RMO; ++i) one[i] = 1.0f, mul[i] = scale;
  row32::store_tile<L::RS>(acc_dv, one, dv + long(n) * T * ldg + hd, ldg, k0, oy, 4 * cg, T, D);
  row32::store_tile<L::RS>(acc_dk, mul, dk + long(n) * T * ldg + hd, ldg, k0, oy, 4 * cg, T, D);
}

template <int DP>
cudaError_t launch_wide_bwd(const float* q, const float* k, const float* v, const float* dout,
                            float* dq, float* dk, float* dv, float* stats, int N, int T, int H,
                            long ldq, long ldk, long ldv, long lddo, long ldg, cudaStream_t s) {
  using LQ = WideDq<DP>;
  using LK = WideDkdv<DP>;
  static_assert(LK::BYTES <= size_t(ATT_MAX_SMEM), "K3 dk/dv tiles exceed shared memory");
  const size_t bytes_dq = LQ::bytes(T);
  if (bytes_dq > size_t(ATT_MAX_SMEM)) return cudaErrorInvalidValue;
  auto k_dq = attn_wide_bwd_dq_kernel<DP>;
  auto k_dkdv = attn_wide_bwd_dkdv_kernel<DP>;
  cudaError_t err =
      cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes_dq));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(LK::BYTES));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(float(DP));
  dim3 grid_dq((T + BQ - 1) / BQ, H, N), grid_dkdv((T + LK::BK - 1) / LK::BK, H, N);
  k_dq<<<grid_dq, THREADS, bytes_dq, s>>>(q, k, v, dout, dq, stats, T, H, DP, ldq, ldk, ldv, lddo,
                                          ldg, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k_dkdv<<<grid_dkdv, THREADS, LK::BYTES, s>>>(q, k, v, dout, dk, dv, stats, T, H, DP, ldq, ldk,
                                               ldv, lddo, ldg, scale);
  return cudaGetLastError();
}

}  // namespace wide32

cudaError_t launch_attn_bwd_wide_f32(const float* q, const float* k, const float* v,
                                     const float* dout, float* dq, float* dk, float* dv,
                                     float* stats, int N, int T, int H, int D, long ldq, long ldk,
                                     long ldv, long lddo, long ldg, cudaStream_t s) {
  if (N < 1 || H < 1 || T < 1 || T > long32::MAX_T || (D != 128 && D != 256))
    return cudaErrorInvalidValue;
  if (D == 128)
    return wide32::launch_wide_bwd<128>(q, k, v, dout, dq, dk, dv, stats, N, T, H, ldq, ldk,
                                        ldv, lddo, ldg, s);
  return wide32::launch_wide_bwd<256>(q, k, v, dout, dq, dk, dv, stats, N, T, H, ldq, ldk, ldv,
                                      lddo, ldg, s);
}

}  // namespace lfm
