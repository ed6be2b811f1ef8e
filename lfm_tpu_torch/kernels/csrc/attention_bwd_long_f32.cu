// f32 K3 past T = 256 (attention_long_f32.cuh): the instances and launcher
// of its dq kernel, followed by the dk/dv kernel of attention_row_f32.cuh,
// compiled apart from K3's other sources so that they build in parallel.
#include "attention.cuh"
#include "attention_long_f32.cuh"

namespace lfm {
namespace {

template <int DP, int TK>
cudaError_t launch_bwd_long(const float* q, const float* k, const float* v, const float* dout,
                            float* dq, float* dk, float* dv, float* stats, int N, int T, int H,
                            int D, long ldq, long ldk, long ldv, long lddo, long ldg,
                            cudaStream_t s) {
  using L = long32::LongDqLayout<DP, TK>;
  using LK = row32::DkdvLayout<DP>;
  static_assert(L::BYTES <= size_t(ATT_MAX_SMEM) && LK::BYTES <= size_t(ATT_MAX_SMEM),
                "K3 tiles exceed shared memory");
  auto k_dq = long32::attn_long_bwd_dq_kernel<DP, TK>;
  auto k_dkdv = row32::attn_row_bwd_dkdv_kernel<DP>;
  const int bytes_dq = int(L::BYTES), bytes_dkdv = int(LK::BYTES);
  cudaError_t err =
      cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_dkdv);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(float(D));
  dim3 grid_dq((T + long32::DBQ - 1) / long32::DBQ, H, N);
  dim3 grid_dkdv((T + LK::BK - 1) / LK::BK, H, N);
  k_dq<<<grid_dq, long32::THREADS, bytes_dq, s>>>(q, k, v, dout, dq, stats, T, H, D, ldq, ldk,
                                                  ldv, lddo, ldg, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k_dkdv<<<grid_dkdv, row32::THREADS, bytes_dkdv, s>>>(q, k, v, dout, dk, dv, stats, T, H, D,
                                                        ldq, ldk, ldv, lddo, ldg, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd_long_dp(const float* q, const float* k, const float* v, const float* dout,
                               float* dq, float* dk, float* dv, float* stats, int N, int T,
                               int H, int D, long ldq, long ldk, long ldv, long lddo, long ldg,
                               cudaStream_t s) {
  if (T <= 512)
    return launch_bwd_long<DP, 512>(q, k, v, dout, dq, dk, dv, stats, N, T, H, D, ldq, ldk, ldv,
                                    lddo, ldg, s);
  return launch_bwd_long<DP, 1024>(q, k, v, dout, dq, dk, dv, stats, N, T, H, D, ldq, ldk, ldv,
                                   lddo, ldg, s);
}

}  // namespace

cudaError_t launch_attn_bwd_long_f32(const float* q, const float* k, const float* v,
                                     const float* dout, float* dq, float* dk, float* dv,
                                     float* stats, int N, int T, int H, int D, long ldq, long ldk,
                                     long ldv, long lddo, long ldg, cudaStream_t s) {
  if (N < 1 || H < 1 || T < 1 || T > long32::MAX_T || D < 8 || D > 80 || D % 8)
    return cudaErrorInvalidValue;
  if (D <= 64)
    return launch_bwd_long_dp<64>(q, k, v, dout, dq, dk, dv, stats, N, T, H, D, ldq, ldk, ldv,
                                  lddo, ldg, s);
  return launch_bwd_long_dp<80>(q, k, v, dout, dq, dk, dv, stats, N, T, H, D, ldq, ldk, ldv,
                                lddo, ldg, s);
}

}  // namespace lfm
