// C entry point of K3, the port of lfm_tpu/kernels/flash_attention.py::
// attention_small_bwd: bf16 runs the wgmma + TMA kernels of
// attention_bwd_sm90.cuh (launched here); f32 is split by shape: at D 128 /
// 256 (the origin ADM) attention_bwd_wide_f32.cu; at D <= 80 and T <= 256
// the one-pass kernels of attention_row_f32.cuh (attention_bwd_row_f32.cu),
// past it the dq kernel of attention_long_f32.cuh with the same dk/dv kernel
// (attention_bwd_long_f32.cu).
#include "attention.cuh"
#include "attention_bwd_sm90.cuh"

namespace lfm {
namespace {

// The function attributes are set first: those runtime calls make the
// device's context current in a thread that has not used it yet (an autograd
// worker), which the tensor maps' encoder needs.
template <int DP>
cudaError_t launch_bwd_dp(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, bf16* dq,
                          bf16* dk, bf16* dv, float* stats, int N, int T, int H, int D, long ldq,
                          long ldk, long ldv, long lddo, long ldg, cudaStream_t stream) {
  using B = sm90::TileBytes<DP>;
  constexpr int S = sm90::BWD_STAGES;
  const int bytes_dq = 1024 + (2 + 2 * S) * B::TILE + 8 * (1 + 2 * S);
  const int bytes_dkdv = bytes_dq + S * sm90::BWD_STAT_BYTES;
  auto k_dq = sm90::attn_bwd_dq_kernel<DP>;
  auto k_dkdv = sm90::attn_bwd_dkdv_kernel<DP>;
  cudaError_t err =
      cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_dkdv);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv, mdo;
  if ((err = make_slab_map(&mq, q, N, T, H, D, ldq)) != cudaSuccess) return err;
  if ((err = make_slab_map(&mk, k, N, T, H, D, ldk)) != cudaSuccess) return err;
  if ((err = make_slab_map(&mv, v, N, T, H, D, ldv)) != cudaSuccess) return err;
  if ((err = make_slab_map(&mdo, dout, N, T, H, D, lddo)) != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(float(D)), scale_log2 = 1.4426950408889634f * scale;
  dim3 grid((T + sm90::ROWS - 1) / sm90::ROWS, H, N);
  k_dq<<<grid, sm90::WG_THREADS, bytes_dq, stream>>>(mq, mk, mv, mdo, dq, stats, T, D, ldg, scale,
                                                     scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k_dkdv<<<grid, sm90::WG_THREADS, bytes_dkdv, stream>>>(mq, mk, mv, mdo, dk, dv, stats, T, D,
                                                         ldg, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_attn_bwd_sm90(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                                 bf16* dq, bf16* dk, bf16* dv, float* stats, int N, int T, int H,
                                 int D, long ldq, long ldk, long ldv, long lddo, long ldg,
                                 cudaStream_t stream) {
  if (N < 1 || T < 1 || T > 1024 || H < 1 || D < 8 || D > 80 || D % 8) return cudaErrorInvalidValue;
  if (D <= 64)
    return launch_bwd_dp<64>(q, k, v, dout, dq, dk, dv, stats, N, T, H, D, ldq, ldk, ldv, lddo,
                             ldg, stream);
  return launch_bwd_dp<80>(q, k, v, dout, dq, dk, dv, stats, N, T, H, D, ldq, ldk, ldv, lddo, ldg,
                           stream);
}

}  // namespace lfm

// q, k, v, dout: (N, T, H*D) slabs with row strides ldq/ldk/ldv/lddo
// (elements); dq, dk, dv: slabs with row stride ldg; stats: f32 scratch of
// 3 * N * H * Tp floats, Tp = T rounded up to 64 (bf16 uses 2 * N * H * Tp
// of it, f32 3 * N * H * T). bf16 when f32 == 0, float otherwise. D: 8-80 a
// multiple of 8 in both types, 128 and 256 in float. Launches
// both kernels on `stream`, allocates nothing, returns the first error.
extern "C" int lfm_attention_small_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       void* stats, int N, int T, int H, int D, int ldq, int ldk,
                                       int ldv, int lddo, int ldg, int f32, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto st = static_cast<float*>(stats);
  if (f32) {
    auto c = [](const void* p) { return static_cast<const float*>(p); };
    auto m = [](void* p) { return static_cast<float*>(p); };
    if (D > 80)
      return static_cast<int>(lfm::launch_attn_bwd_wide_f32(c(q), c(k), c(v), c(dout), m(dq),
                                                             m(dk), m(dv), st, N, T, H, D, ldq,
                                                             ldk, ldv, lddo, ldg, s));
    if (T <= 256)
      return static_cast<int>(lfm::launch_attn_bwd_row_f32(c(q), c(k), c(v), c(dout), m(dq),
                                                            m(dk), m(dv), st, N, T, H, D, ldq,
                                                            ldk, ldv, lddo, ldg, s));
    return static_cast<int>(lfm::launch_attn_bwd_long_f32(c(q), c(k), c(v), c(dout), m(dq),
                                                           m(dk), m(dv), st, N, T, H, D, ldq,
                                                           ldk, ldv, lddo, ldg, s));
  }
  using lfm::bf16;
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<bf16*>(p); };
  return static_cast<int>(lfm::launch_attn_bwd_sm90(c(q), c(k), c(v), c(dout), m(dq), m(dk),
                                                    m(dv), st, N, T, H, D, ldq, ldk, ldv, lddo,
                                                    ldg, s));
}
