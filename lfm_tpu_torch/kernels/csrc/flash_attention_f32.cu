// f32 K4 (attention_long_f32.cuh): its instances and launcher, compiled
// apart from the bf16 dispatch (flash_attention.cu) so that the two build in
// parallel. f32 K1 at 256 < T <= 512 launches the same instances, its whole
// row one key block (attention_long_f32.cu).
#include "attention.cuh"
#include "attention_long_f32.cuh"

namespace lfm {

cudaError_t launch_flash_f32(const float* q, const float* k, const float* v, float* o, int N,
                             int T, int H, int D, int BK, long ldq, long ldk, long ldv, long ldo,
                             cudaStream_t s) {
  if (N < 1 || H < 1 || T < 1 || BK < 1 || BK > long32::BK_MAX || T % BK || D % 8)
    return cudaErrorInvalidValue;
  using long32::FBQ, long32::BK_MAX, long32::launch_flash;
  switch ((D + 15) / 16) {
    case 4: return launch_flash<64, FBQ, BK_MAX>(q, k, v, o, N, T, H, D, BK, ldq, ldk, ldv, ldo, s);
    case 5: return launch_flash<80, FBQ, BK_MAX>(q, k, v, o, N, T, H, D, BK, ldq, ldk, ldv, ldo, s);
    case 8:
      return launch_flash<128, FBQ, BK_MAX>(q, k, v, o, N, T, H, D, BK, ldq, ldk, ldv, ldo, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace lfm

// The largest f32 key block lfm_flash_attention takes: K4 holds a block's
// scores in shared memory.
extern "C" int lfm_flash_f32_max_block() { return lfm::long32::BK_MAX; }
