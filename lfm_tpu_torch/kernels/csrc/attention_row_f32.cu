// f32 K1 at T <= 256, D 56-80 (attention_row_f32.cuh): the instances and
// the launcher, compiled apart from K3's (attention_bwd_row_f32.cu) so that
// the two build in parallel.
#include "attention.cuh"
#include "attention_row_f32.cuh"

namespace lfm {
namespace {

template <int DP, int TK>
cudaError_t launch_row(const float* q, const float* k, const float* v, float* o, int N, int T,
                       int H, int D, long ldq, long ldk, long ldv, long ldo, cudaStream_t s) {
  using L = row32::RowLayout<DP, TK>;
  static_assert(L::FWD_BYTES <= size_t(ATT_MAX_SMEM), "K1 tiles exceed shared memory");
  auto kernel = row32::attn_row_kernel<DP, TK>;
  const int bytes = int(L::FWD_BYTES);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T + row32::BQ - 1) / row32::BQ, H, N);
  kernel<<<grid, row32::THREADS, bytes, s>>>(q, k, v, o, T, D, ldq, ldk, ldv, ldo,
                                              1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_row_dp(const float* q, const float* k, const float* v, float* o, int N, int T,
                          int H, int D, long ldq, long ldk, long ldv, long ldo, cudaStream_t s) {
  if (T <= 64) return launch_row<DP, 64>(q, k, v, o, N, T, H, D, ldq, ldk, ldv, ldo, s);
  if (T <= 128) return launch_row<DP, 128>(q, k, v, o, N, T, H, D, ldq, ldk, ldv, ldo, s);
  return launch_row<DP, 256>(q, k, v, o, N, T, H, D, ldq, ldk, ldv, ldo, s);
}

}  // namespace

cudaError_t launch_attention_row_f32(const float* q, const float* k, const float* v, float* o,
                                     int N, int T, int H, int D, long ldq, long ldk, long ldv,
                                     long ldo, cudaStream_t s) {
  if (N < 1 || H < 1 || T < 1 || T > row32::MAX_T || D < 8 || D > 80 || D % 8)
    return cudaErrorInvalidValue;
  if (D <= 64) return launch_row_dp<64>(q, k, v, o, N, T, H, D, ldq, ldk, ldv, ldo, s);
  return launch_row_dp<80>(q, k, v, o, N, T, H, D, ldq, ldk, ldv, ldo, s);
}

}  // namespace lfm
