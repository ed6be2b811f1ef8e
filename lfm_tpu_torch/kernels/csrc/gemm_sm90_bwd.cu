// The NN and TN layouts of gemm_sm90.cuh's wgmma + TMA GEMM: the eight
// GEMMs of K5's backward (dit_block_train.cu) and a C entry point of their
// own (kernels/gemm.py's gemm_nn, gemm_tn). The MLP half
// (lfm_dit_block_train_mlp_bwd):
//   du  = (bf16(dh2) W2) gelu'(u)   NN, EPI_DGELU into bf16, db1's partials,
//                                   and gb = bf16(gelu(u)) from the same tanh
//   dW2 = bf16(dh2)^T gb            TN, EPI_STORE into f32
//   dh  = bf16(du) W1               NN, EPI_STORE into f32
//   dW1 = bf16(du)^T h2b            TN, EPI_STORE into f32
// and the attention half (lfm_dit_block_train_attn_bwd):
//   do  = bf16(bf16(dpr) Wproj)     NN, EPI_STORE into bf16
//   dWproj = bf16(dpr)^T ao         TN, EPI_STORE into f32
//   dhb = dqkv Wqkv                 NN, EPI_STORE into f32
//   dWqkv = dqkv^T hb               TN, EPI_STORE into f32
// Compiled apart from the NT instances (gemm_sm90.cu) so that the two build
// in parallel.
#include "gemm_sm90.cuh"

namespace lfm {

using sm90::aligned;
using sm90::launch_kind;

cudaError_t launch_gemm_bwd(int layout, int epi, const bf16* A, const bf16* B, void* out,
                            bool out_f32, const bf16* u, float* part, bf16* aux, int M, int N,
                            int K, cudaStream_t s) {
  // TMA: every row of a stored matrix a multiple of 16 bytes
  if (M < 1 || N < 128 || N % 128 || K < 8 || K % 8 || (layout == LAYOUT_TN && M % 8) ||
      !aligned(A, 16) || !aligned(B, 16) || !aligned(out, 16))
    return cudaErrorInvalidValue;
  sm90::GemmArgs g{nullptr, out, nullptr, nullptr, nullptr, nullptr, u, part, M, N, K, 1, 0};
  if (epi == EPI_DGELU) g.aux = aux;
  if (epi == EPI_STORE && out_f32) {
    if (layout == LAYOUT_NN) return launch_kind<LAYOUT_NN, sm90::KIND_BIAS, bf16, float>(A, B, g, s);
    if (layout == LAYOUT_TN) return launch_kind<LAYOUT_TN, sm90::KIND_BIAS, bf16, float>(A, B, g, s);
  }
  if (epi == EPI_STORE && layout == LAYOUT_NN)
    return launch_kind<LAYOUT_NN, sm90::KIND_BIAS, bf16, bf16>(A, B, g, s);
  if (epi == EPI_DGELU && !out_f32 && layout == LAYOUT_NN && u != nullptr && part != nullptr &&
      aligned(u, 4) && aligned(aux, 16))
    return launch_kind<LAYOUT_NN, sm90::KIND_DGELU, bf16, bf16>(A, B, g, s);
  return cudaErrorInvalidValue;
}

}  // namespace lfm

// out = a (M, K) . b (K, N) (layout LAYOUT_NN = 1) or a (K, M)^T . b (K, N)
// (LAYOUT_TN = 2): a, b bf16 row-major; epi EPI_STORE (5) into f32 (out_f32
// = 1) or, NN only, into bf16 (out_f32 = 0), or, NN only, EPI_DGELU (6)
// into bf16 with u (M, N) bf16, part
// (ceil(M / 128), N) f32 and aux (M, N) bf16 or null (du = value *
// gelu_tanh'(u), part the column sums of du over each 128-row tile, aux =
// bf16(gelu_tanh(u))). N % 128 == 0, K % 8 == 0, TN M % 8 == 0. One launch
// on `stream`, allocates nothing; returns the launch's error.
extern "C" int lfm_gemm_bwd(const void* a, const void* b, void* out, const void* u, void* part,
                            void* aux, int layout, int epi, int out_f32, int M, int N, int K,
                            void* stream) {
  using lfm::bf16;
  return static_cast<int>(lfm::launch_gemm_bwd(
      layout, epi, static_cast<const bf16*>(a), static_cast<const bf16*>(b), out, out_f32 != 0,
      static_cast<const bf16*>(u), static_cast<float*>(part), static_cast<bf16*>(aux), M, N, K,
      static_cast<cudaStream_t>(stream)));
}
