// f32 K3 at T <= 256, D 56-80 (attention_row_f32.cuh): the instances and
// the launcher of its two kernels, compiled apart from K1's.
#include "attention.cuh"
#include "attention_row_f32.cuh"

namespace lfm {
namespace {

template <int DP, int TK>
cudaError_t launch_bwd_row(const float* q, const float* k, const float* v, const float* dout,
                           float* dq, float* dk, float* dv, float* stats, int N, int T, int H,
                           int D, long ldq, long ldk, long ldv, long lddo, long ldg,
                           cudaStream_t s) {
  using L = row32::RowLayout<DP, TK>;
  using LK = row32::DkdvLayout<DP>;
  static_assert(L::DQ_BYTES <= size_t(ATT_MAX_SMEM) && LK::BYTES <= size_t(ATT_MAX_SMEM),
                "K3 tiles exceed shared memory");
  auto k_dq = row32::attn_row_bwd_dq_kernel<DP, TK>;
  auto k_dkdv = row32::attn_row_bwd_dkdv_kernel<DP>;
  const int bytes_dq = int(L::DQ_BYTES), bytes_dkdv = int(LK::BYTES);
  cudaError_t err =
      cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_dkdv);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(float(D));
  dim3 grid_dq((T + row32::BQ - 1) / row32::BQ, H, N), grid_dkdv((T + LK::BK - 1) / LK::BK, H, N);
  k_dq<<<grid_dq, row32::THREADS, bytes_dq, s>>>(q, k, v, dout, dq, stats, T, H, D, ldq, ldk, ldv,
                                                  lddo, ldg, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k_dkdv<<<grid_dkdv, row32::THREADS, bytes_dkdv, s>>>(q, k, v, dout, dk, dv, stats, T, H, D,
                                                        ldq, ldk, ldv, lddo, ldg, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd_row_dp(const float* q, const float* k, const float* v, const float* dout,
                              float* dq, float* dk, float* dv, float* stats, int N, int T, int H,
                              int D, long ldq, long ldk, long ldv, long lddo, long ldg,
                              cudaStream_t s) {
  if (T <= 64)
    return launch_bwd_row<DP, 64>(q, k, v, dout, dq, dk, dv, stats, N, T, H, D, ldq, ldk, ldv,
                                  lddo, ldg, s);
  if (T <= 128)
    return launch_bwd_row<DP, 128>(q, k, v, dout, dq, dk, dv, stats, N, T, H, D, ldq, ldk, ldv,
                                   lddo, ldg, s);
  return launch_bwd_row<DP, 256>(q, k, v, dout, dq, dk, dv, stats, N, T, H, D, ldq, ldk, ldv,
                                 lddo, ldg, s);
}

}  // namespace

cudaError_t launch_attn_bwd_row_f32(const float* q, const float* k, const float* v,
                                    const float* dout, float* dq, float* dk, float* dv,
                                    float* stats, int N, int T, int H, int D, long ldq, long ldk,
                                    long ldv, long lddo, long ldg, cudaStream_t s) {
  if (N < 1 || H < 1 || T < 1 || T > row32::MAX_T || D < 8 || D > 80 || D % 8)
    return cudaErrorInvalidValue;
  if (D <= 64)
    return launch_bwd_row_dp<64>(q, k, v, dout, dq, dk, dv, stats, N, T, H, D, ldq, ldk, ldv,
                                 lddo, ldg, s);
  return launch_bwd_row_dp<80>(q, k, v, dout, dq, dk, dv, stats, N, T, H, D, ldq, ldk, ldv, lddo,
                               ldg, s);
}

}  // namespace lfm
