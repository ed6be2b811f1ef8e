// K1 at the origin ADM's wide f32 heads (attention.cuh), compiled apart from
// the DiT's instances so that the two build in parallel.
#include "attention.cuh"

namespace lfm {

cudaError_t launch_attention_wide_f32(const float* q, const float* k, const float* v, float* o,
                                      int N, int T_len, int H, int D, long ldq, long ldk,
                                      long ldv, long ldo, cudaStream_t s) {
  switch ((D + 15) / 16) {
    case 8:
      return launch_attn_dp<float, 128, false>(q, k, v, o, N, T_len, H, D, ldq, ldk, ldv, ldo, s);
    case 16:
      return launch_attn_dp<float, 256, false>(q, k, v, o, N, T_len, H, D, ldq, ldk, ldv, ldo, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace lfm
