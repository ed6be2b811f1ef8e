// f32 K3 (attention_bwd.cuh): its launcher, compiled apart from the bf16
// kernels (attention_bwd.cu) so that the two build in parallel.
#include "attention_bwd.cuh"

namespace lfm {

cudaError_t launch_attn_bwd_f32(const float* q, const float* k, const float* v,
                                const float* dout, float* dq, float* dk, float* dv, float* stats,
                                int N, int T_len, int H, int D, long ldq, long ldk, long ldv,
                                long lddo, long ldg, cudaStream_t s) {
  switch ((D + 15) / 16) {
    case 4:
      return launch_attn_bwd_dp<float, 64>(q, k, v, dout, dq, dk, dv, stats, N, T_len, H, D, ldq,
                                           ldk, ldv, lddo, ldg, s);
    case 5:
      return launch_attn_bwd_dp<float, 80>(q, k, v, dout, dq, dk, dv, stats, N, T_len, H, D, ldq,
                                           ldk, ldv, lddo, ldg, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace lfm
