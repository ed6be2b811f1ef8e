// f32 K4 (attention_long_f32.cuh): its instances and launcher, compiled
// apart from the bf16 dispatch (flash_attention.cu) so that the two build in
// parallel.
#include "attention.cuh"
#include "attention_long_f32.cuh"

namespace lfm {
namespace {

template <int DP>
cudaError_t launch_flash_dp(const float* q, const float* k, const float* v, float* o, int N,
                            int T, int H, int D, int BK, long ldq, long ldk, long ldv, long ldo,
                            cudaStream_t s) {
  using L = long32::FlashLayout<DP>;
  static_assert(L::BYTES <= size_t(ATT_MAX_SMEM), "K4 tiles exceed shared memory");
  auto kernel = long32::flash_f32_kernel<DP>;
  const int bytes = int(L::BYTES);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T + long32::FBQ - 1) / long32::FBQ, H, N);
  kernel<<<grid, long32::THREADS, bytes, s>>>(q, k, v, o, T, D, BK, ldq, ldk, ldv, ldo,
                                               1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_flash_f32(const float* q, const float* k, const float* v, float* o, int N,
                             int T, int H, int D, int BK, long ldq, long ldk, long ldv, long ldo,
                             cudaStream_t s) {
  if (N < 1 || H < 1 || T < 1 || BK < 1 || BK > long32::BK_MAX || T % BK || D % 8)
    return cudaErrorInvalidValue;
  switch ((D + 15) / 16) {
    case 4: return launch_flash_dp<64>(q, k, v, o, N, T, H, D, BK, ldq, ldk, ldv, ldo, s);
    case 5: return launch_flash_dp<80>(q, k, v, o, N, T, H, D, BK, ldq, ldk, ldv, ldo, s);
    case 8: return launch_flash_dp<128>(q, k, v, o, N, T, H, D, BK, ldq, ldk, ldv, ldo, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace lfm

// The largest f32 key block lfm_flash_attention takes: K4 holds a block's
// scores in shared memory.
extern "C" int lfm_flash_f32_max_block() { return lfm::long32::BK_MAX; }
