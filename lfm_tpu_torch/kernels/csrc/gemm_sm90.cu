// The NT GEMM for Hopper (gemm_sm90.cuh): its instances, its launcher
// (launch_gemm_nt, declared in gemm.cuh, called by K2, K5's forward and
// lfm_bf16_mlp) and a C entry point of its own (kernels/gemm.py). The NN
// and TN layouts are built apart, in gemm_sm90_bwd.cu, so that the two
// compile in parallel.
#include "gemm_sm90.cuh"

namespace lfm {

using sm90::aligned;
using sm90::launch_kind;

cudaError_t launch_gemm_nt(int epi, const bf16* A, const bf16* W, const bf16* bias, void* out,
                           bool out_f32, const void* resid, bool resid_f32, const bf16* mod,
                           int gate_idx, int T, bf16* aux, bf16* aux2, int M, int N, int K,
                           cudaStream_t s) {
  if (M < 1 || N < 128 || N % 128 || K < 64 || K % 64 || !aligned(A, 16) || !aligned(W, 16) ||
      !aligned(out, 16) || !aligned(bias, 4) || !aligned(aux, 16) || !aligned(aux2, 16))
    return cudaErrorInvalidValue;
  sm90::GemmArgs g{epi == EPI_STORE ? nullptr : bias, out, resid, mod, aux, aux2, nullptr,
                   nullptr, M, N, K, T, gate_idx};
  switch (epi) {
    case EPI_BIAS:
    case EPI_STORE:
      if (out_f32) return cudaErrorInvalidValue;
      return launch_kind<LAYOUT_NT, sm90::KIND_BIAS, bf16, bf16>(A, W, g, s);
    case EPI_GELU:
    case EPI_GELU_AUX:
      if (out_f32) return cudaErrorInvalidValue;
      if (epi == EPI_GELU) g.aux = nullptr;
      return launch_kind<LAYOUT_NT, sm90::KIND_GELU, bf16, bf16>(A, W, g, s);
    case EPI_GATED:
    case EPI_GATED_AUX:
      if (resid == nullptr || mod == nullptr || T < 1 || !aligned(resid, resid_f32 ? 8 : 4) ||
          !aligned(mod, 4) || out_f32 == resid_f32)
        return cudaErrorInvalidValue;
      if (epi == EPI_GATED) g.aux = g.aux2 = nullptr;
      if (out_f32) return launch_kind<LAYOUT_NT, sm90::KIND_GATED, bf16, float>(A, W, g, s);
      return launch_kind<LAYOUT_NT, sm90::KIND_GATED, float, bf16>(A, W, g, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace lfm

// out = epilogue(a (M, K) . w (N, K)^T): a, w bf16; epi one of gemm.cuh's
// NT epilogues (EPI_BIAS, EPI_GELU, EPI_GATED, EPI_GELU_AUX, EPI_GATED_AUX,
// EPI_STORE); out bf16 or f32 (out_f32), resid bf16 or f32 (resid_f32);
// bias, aux, aux2 may be null. N % 128 == 0, K % 64 == 0. One launch on
// `stream`, allocates nothing; returns the launch's error.
extern "C" int lfm_gemm(const void* a, const void* w, const void* bias, void* out,
                        const void* resid, const void* mod, void* aux, void* aux2, int epi,
                        int out_f32, int resid_f32, int gate_idx, int T, int M, int N, int K,
                        void* stream) {
  using lfm::bf16;
  return static_cast<int>(lfm::launch_gemm_nt(
      epi, static_cast<const bf16*>(a), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), out, out_f32 != 0, resid, resid_f32 != 0,
      static_cast<const bf16*>(mod), gate_idx, T, static_cast<bf16*>(aux),
      static_cast<bf16*>(aux2), M, N, K, static_cast<cudaStream_t>(stream)));
}
