// f32 K1 at the origin ADM's wide heads, D = 128 (celeb256_adm) and 256
// (celeb512_adm, church_adm): `_attn_small_kernel` of
// lfm_tpu/kernels/flash_attention.py in f32, s = scale q k^T, p = exp(s - m)
// with the row's exact max, o = (p v) / l, all f32. Compiled apart from the
// DiT's instances (attention.cu) so that the two build in parallel. Split by
// shape, one kernel for each (flash_attention.f32_k1_route mirrors it):
//  - T <= 64: attn_short_f32_kernel below, sized to T;
//  - past it: attention_long_f32.cuh's key-block kernel with the whole row
//    one block (QK^T once, the exact max, k and v through a cp.async ring
//    under the math): at D = 128 K4's <128, 64, 512> up to T = 512
//    (flash_attention_f32.cu) and <128, 32, 1024> past it; at D = 256
//    <256, 32, 1024> (the shared-memory arithmetic is in that header).
//
// The presets attend at T = 16 (celeb256_adm: (200, 16, 4, 128), 6 calls an
// evaluation) and T = 64. There the work is tiny (at (200, 16, 4, 128) 105
// MFLOP, 1.6 us on the 67 TFLOP/s f32 units) and the bytes set the bound:
// q, k, v read and o written once, 26 MB, 7.8 us at 3.35 TB/s. So
// attn_short_f32_kernel, for T <= 64, is sized to T and to occupancy:
//  - one CTA of 128 threads takes BQ query rows (16 for T <= 16, else 32)
//    of one (sample, head) and the whole row of TK keys (T rounded up to 16,
//    32 or 64); its q, k and v are loaded once by 16-byte cp.async (rows
//    past T zero-filled), all in flight together;
//  - one pass: S = scale q k^T by f32 FMA (each thread one key and BQ * TK /
//    128 query rows, float4 reads along D; the rows of q and k are padded by
//    16 bytes so that the eight lanes of a 128-byte phase hit distinct
//    banks), written to shared memory; each warp takes whole rows for the
//    exact max, exp and sum; then O = P V by f32 FMA (each thread 4 columns
//    of BQ * 4 * DP / 512 rows, v read as float4 along D), times 1 / l.
//    l is summed in two chains of 32 keys, added, and O is scaled by 1 / l;
//  - shared memory 26 KB at (T 16, D 128), so up to eight CTAs share an SM
//    (800 CTAs at (200, 16, 4, 128): one wave with every load in flight).
// Products stay f32 FMA on the CUDA cores (no TF32, as the TPU kernel's
// f32 products), and no tensor core or TMA is used: they buy nothing at
// this size.
#include "attention.cuh"
#include "attention_long_f32.cuh"

namespace lfm {
namespace {

constexpr int SHORT_THREADS = 128;
constexpr int SHORT_MAX_T = 64;

// shared memory of one CTA, in floats: q (BQ rows) and k (TK rows) padded
// by 4 floats a row, v (TK rows), S / P (BQ x TK + 1), 1 / l (BQ)
template <int DP, int TK, int BQ>
struct ShortLayout {
  static constexpr int LDQ = DP + 4;
  static constexpr int LDP = TK + 1;
  static constexpr int K = BQ * LDQ, V = K + TK * LDQ, P = V + TK * DP, L = P + BQ * LDP;
  static constexpr int BYTES = 4 * (L + BQ);
};

template <int DP, int TK, int BQ>
__global__ void __launch_bounds__(SHORT_THREADS)
attn_short_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int T, long ldq,
                      long ldk, long ldv, long ldo, float scale) {
  using L = ShortLayout<DP, TK, BQ>;
  extern __shared__ __align__(16) float sm[];
  float *qs = sm, *ks = sm + L::K, *vs = sm + L::V, *ps = sm + L::P, *ls = sm + L::L;
  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ, tid = threadIdx.x;
  const long D = DP;
  const float* qb = q + long(n) * T * ldq + h * D;
  const float* kb = k + long(n) * T * ldk + h * D;
  const float* vb = v + long(n) * T * ldv + h * D;

  constexpr int C4 = DP / 4;  // 16-byte chunks a row
  for (int id = tid; id < BQ * C4; id += SHORT_THREADS) {
    const int r = id / C4, c = (id % C4) * 4;
    const bool ok = q0 + r < T;
    cp_async16(qs + r * L::LDQ + c, ok ? qb + (q0 + r) * ldq + c : qb, ok);
  }
  for (int id = tid; id < TK * C4; id += SHORT_THREADS) {
    const int r = id / C4, c = (id % C4) * 4;
    const bool ok = r < T;
    cp_async16(ks + r * L::LDQ + c, ok ? kb + r * ldk + c : kb, ok);
    cp_async16(vs + r * DP + c, ok ? vb + r * ldv + c : vb, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // S = scale q k^T: key c, query rows r0 + j * RS
  {
    constexpr int RS = SHORT_THREADS / TK, E = BQ / RS;
    static_assert(BQ % RS == 0, "query rows per thread");
    const int c = tid % TK, r0 = tid / TK;
    float acc[E];
#pragma unroll
    for (int j = 0; j < E; ++j) acc[j] = 0.0f;
    const float* kr = ks + c * L::LDQ;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (r0 + j * RS) * L::LDQ + d);
        acc[j] = fmaf(qv.x, kv.x, acc[j]);
        acc[j] = fmaf(qv.y, kv.y, acc[j]);
        acc[j] = fmaf(qv.z, kv.z, acc[j]);
        acc[j] = fmaf(qv.w, kv.w, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) ps[(r0 + j * RS) * L::LDP + c] = c < T ? scale * acc[j] : -INFINITY;
  }
  __syncthreads();

  // the exact row max, p = exp(s - m), l = sum p, 1 / l: warp w takes rows
  // w, w + 4, ... l is summed in two chains (keys 0-31 and 32-63 each in
  // order), then the two added
  {
    const int lane = tid % 32;
    for (int r = tid / 32; r < BQ; r += SHORT_THREADS / 32) {
      float* pr = ps + r * L::LDP;
      const float s0 = lane < TK ? pr[lane] : -INFINITY;
      const float s1 = lane + 32 < TK ? pr[lane + 32] : -INFINITY;
      float m = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane < TK) pr[lane] = expf(s0 - m);
      if (lane + 32 < TK) pr[lane + 32] = expf(s1 - m);
      __syncwarp();
      float half = 0.0f;
      if (lane < 2)
        for (int c = 32 * lane; c < 32 * lane + 32 && c < TK; ++c) half += pr[c];
      const float l = __shfl_sync(0xffffffffu, half, 0) + __shfl_sync(0xffffffffu, half, 1);
      if (lane == 0) ls[r] = 1.0f / l;
    }
  }
  __syncthreads();

  // O = P V times 1 / l: columns d4 .. d4 + 3, query rows r0 + j * RS
  {
    constexpr int RS = SHORT_THREADS / C4, E = BQ / RS;
    static_assert(BQ % RS == 0, "query rows per thread");
    const int d4 = (tid % C4) * 4, r0 = tid / C4;
    float4 acc[E];
#pragma unroll
    for (int j = 0; j < E; ++j) acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c = 0; c < T; ++c) {
      const float4 vv = *reinterpret_cast<const float4*>(vs + c * DP + d4);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float p = ps[(r0 + j * RS) * L::LDP + c];
        acc[j].x = fmaf(p, vv.x, acc[j].x);
        acc[j].y = fmaf(p, vv.y, acc[j].y);
        acc[j].z = fmaf(p, vv.z, acc[j].z);
        acc[j].w = fmaf(p, vv.w, acc[j].w);
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int r = r0 + j * RS;
      if (q0 + r >= T) continue;
      const float inv = ls[r];
      *reinterpret_cast<float4*>(o + (long(n) * T + q0 + r) * ldo + h * D + d4) =
          make_float4(acc[j].x * inv, acc[j].y * inv, acc[j].z * inv, acc[j].w * inv);
    }
  }
}

template <int DP, int TK, int BQ>
cudaError_t launch_short(const float* q, const float* k, const float* v, float* o, int N, int T,
                         int H, long ldq, long ldk, long ldv, long ldo, cudaStream_t s) {
  using L = ShortLayout<DP, TK, BQ>;
  static_assert(L::BYTES <= ATT_MAX_SMEM, "short attention exceeds shared memory");
  auto kernel = attn_short_f32_kernel<DP, TK, BQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, H, N);
  kernel<<<grid, SHORT_THREADS, L::BYTES, s>>>(q, k, v, o, T, ldq, ldk, ldv, ldo,
                                               1.0f / sqrtf(float(DP)));
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_short_dp(const float* q, const float* k, const float* v, float* o, int N,
                            int T, int H, long ldq, long ldk, long ldv, long ldo, cudaStream_t s) {
  if (T <= 16) return launch_short<DP, 16, 16>(q, k, v, o, N, T, H, ldq, ldk, ldv, ldo, s);
  if (T <= 32) return launch_short<DP, 32, 32>(q, k, v, o, N, T, H, ldq, ldk, ldv, ldo, s);
  return launch_short<DP, 64, 32>(q, k, v, o, N, T, H, ldq, ldk, ldv, ldo, s);
}

}  // namespace

cudaError_t launch_attention_wide_f32(const float* q, const float* k, const float* v, float* o,
                                      int N, int T_len, int H, int D, long ldq, long ldk,
                                      long ldv, long ldo, cudaStream_t s) {
  if ((D != 128 && D != 256) || N < 1 || H < 1 || T_len < 1 || T_len > long32::MAX_T)
    return cudaErrorInvalidValue;
  if (T_len <= SHORT_MAX_T) {
    if (D == 128) return launch_short_dp<128>(q, k, v, o, N, T_len, H, ldq, ldk, ldv, ldo, s);
    return launch_short_dp<256>(q, k, v, o, N, T_len, H, ldq, ldk, ldv, ldo, s);
  }
  // the whole row one key block of BK = T keys
  using long32::K1_BQ, long32::MAX_T, long32::launch_flash;
  if (D == 128 && T_len <= long32::BK_MAX)
    return launch_flash_f32(q, k, v, o, N, T_len, H, D, T_len, ldq, ldk, ldv, ldo, s);
  if (D == 128)
    return launch_flash<128, K1_BQ, MAX_T>(q, k, v, o, N, T_len, H, D, T_len, ldq, ldk, ldv,
                                           ldo, s);
  return launch_flash<256, K1_BQ, MAX_T>(q, k, v, o, N, T_len, H, D, T_len, ldq, ldk, ldv, ldo,
                                         s);
}

}  // namespace lfm
