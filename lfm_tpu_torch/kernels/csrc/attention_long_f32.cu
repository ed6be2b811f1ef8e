// f32 K1 past T = 256 (attention_long_f32.cuh): the launcher and the 32-row
// instances, compiled apart from K4's (flash_attention_f32.cu) so that the
// two build in parallel. K1's whole row is one key block of T keys: at T <=
// 512 K4's own instances (64 query rows, scores of up to 512 keys), past it
// 32 query rows a CTA with scores of up to 1024 keys (64 rows would take
// 264 KB).
#include "attention.cuh"
#include "attention_long_f32.cuh"

namespace lfm {

cudaError_t launch_attention_long_f32(const float* q, const float* k, const float* v, float* o,
                                      int N, int T, int H, int D, long ldq, long ldk, long ldv,
                                      long ldo, cudaStream_t s) {
  if (N < 1 || H < 1 || T <= row32::MAX_T || T > long32::MAX_T || D < 8 || D > 80 || D % 8)
    return cudaErrorInvalidValue;
  if (T <= long32::BK_MAX)
    return launch_flash_f32(q, k, v, o, N, T, H, D, T, ldq, ldk, ldv, ldo, s);
  using long32::K1_BQ, long32::MAX_T, long32::launch_flash;
  if (D <= 64)
    return launch_flash<64, K1_BQ, MAX_T>(q, k, v, o, N, T, H, D, T, ldq, ldk, ldv, ldo, s);
  return launch_flash<80, K1_BQ, MAX_T>(q, k, v, o, N, T, H, D, T, ldq, ldk, ldv, ldo, s);
}

}  // namespace lfm
