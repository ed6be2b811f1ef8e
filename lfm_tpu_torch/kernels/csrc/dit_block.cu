// K2: one DiT block forward (the port of lfm_tpu/kernels/dit_block.py::
// fused_dit_block, `_dit_block_kernel`), with its bf16 rounding points:
//   h   = bf16(LN(x) * (1 + scale_msa) + shift_msa)          ln_modulate
//   qkv = bf16(h Wqkv^T + bqkv)                               gemm, EPI_BIAS
//   ao  = bf16(softmax(q k^T / sqrt(D)) v), p rounded to bf16 attention_sm90.cuh
//   x1  = f32(x) + gate_msa * (ao Wproj^T + bproj)     (f32)  gemm, EPI_GATED
//   h   = bf16(LN(x1) * (1 + scale_mlp) + shift_mlp)          ln_modulate
//   u   = bf16(gelu_tanh(h W1^T + b1))                        gemm, EPI_GELU
//   out = bf16(x1 + gate_mlp * (u W2^T + b2))                 gemm, EPI_GATED
// LayerNorm has no affine, eps 1e-6, var = E[x^2] - E[x]^2, in f32. The
// residual x1 stays f32 between the halves. mod is (N, 6C) bf16 in the order
// shift/scale/gate (msa), shift/scale/gate (mlp). Weights are in
// torch.nn.Linear layout (out, in), row-major, bf16.
//
// What bounds it on the H100: at N=8, T=256, C=1024, hidden 4096 the block
// does 2*N*T*C*(4C + 2*hidden) + 4*N*T*T*C = 53.7 GFLOP and must move about
// 25 MB of weights plus 8 MB of activations, about 1600 flops per byte, far
// above the card's ~295 bf16 flops per byte: it is bound by tensor-core
// operations. The TPU kernel kept all six weight matrices resident in VMEM
// and ran S samples per grid cell; that does not carry over (227 KB of
// shared memory per SM). Here the work is a short fixed sequence of kernels
// on one stream: the four GEMMs are gemm_sm90.cuh's persistent,
// warp-specialised wgmma + TMA kernel with the bias / GELU / gated-residual
// epilogues fused into its register epilogue, and the attention is
// attention_sm90.cuh's wgmma + TMA kernel (whole-row mode at T <= 256). The
// intermediates (h, qkv, ao, x1, u) round-trip device memory, which at
// these sizes is cheap next to the GEMMs.
// The GEMM declarations and the LayerNorm are in gemm.cuh, shared with K5
// (dit_block_train.cu).
#include "attention.cuh"
#include "gemm.cuh"

// x, out: bf16 (N, T, C); mod: bf16 (N, 6C); weights (out, in) bf16 with
// C % 128 == 0, hidden % 128 == 0, C / heads in {56, 64, 72, 80}. Scratch
// from the caller: h (N*T, C) bf16, qkv (N*T, 3C) bf16, ao (N*T, C) bf16,
// x1 (N*T, C) f32, u (N*T, hidden) bf16. Launches seven kernels on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int lfm_dit_block(const void* x, const void* mod, const void* wqkv, const void* bqkv,
                             const void* wproj, const void* bproj, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out, void* h_buf,
                             void* qkv_buf, void* ao_buf, void* x1_buf, void* u_buf, int N, int T,
                             int C, int hidden, int heads, void* stream) {
  using lfm::bf16;
  auto s = static_cast<cudaStream_t>(stream);
  auto bp = [](const void* p) { return static_cast<const bf16*>(p); };
  const int M = N * T, D = C / heads;
  bf16* h = static_cast<bf16*>(h_buf);
  bf16* qkv = static_cast<bf16*>(qkv_buf);
  bf16* ao = static_cast<bf16*>(ao_buf);
  float* x1 = static_cast<float*>(x1_buf);
  bf16* u = static_cast<bf16*>(u_buf);
  const bf16* m = bp(mod);

  // a refused launch never runs; report the first one
#define LFM_CHECK(call)                                   \
  do {                                                    \
    call;                                                 \
    cudaError_t e_ = cudaGetLastError();                  \
    if (e_ != cudaSuccess) return static_cast<int>(e_);   \
  } while (0)
#define LFM_TRY(call)                                     \
  do {                                                    \
    cudaError_t e_ = (call);                              \
    if (e_ != cudaSuccess) return static_cast<int>(e_);   \
  } while (0)
  LFM_CHECK((lfm::ln_modulate_kernel<bf16><<<M, lfm::LN_THREADS, 0, s>>>(bp(x), m, h, T, C, 0, 1)));
  LFM_TRY((lfm::launch_gemm_nt<lfm::EPI_BIAS, bf16, bf16>(h, bp(wqkv), bp(bqkv), qkv, M, 3 * C, C,
                                                          nullptr, nullptr, 0, T, s)));
  LFM_TRY(lfm::launch_attention<true>(qkv, qkv + C, qkv + 2 * C, ao, N, T, heads, D, 3L * C,
                                      3L * C, 3L * C, C, s));
  LFM_TRY((lfm::launch_gemm_nt<lfm::EPI_GATED, bf16, float>(ao, bp(wproj), bp(bproj), x1, M, C, C,
                                                            bp(x), m, 2, T, s)));
  LFM_CHECK((lfm::ln_modulate_kernel<float><<<M, lfm::LN_THREADS, 0, s>>>(x1, m, h, T, C, 3, 4)));
  LFM_TRY((lfm::launch_gemm_nt<lfm::EPI_GELU, bf16, bf16>(h, bp(w1), bp(b1), u, M, hidden, C,
                                                          nullptr, nullptr, 0, T, s)));
  LFM_TRY((lfm::launch_gemm_nt<lfm::EPI_GATED, float, bf16>(u, bp(w2), bp(b2),
                                                            static_cast<bf16*>(out), M, C, hidden,
                                                            x1, m, 5, T, s)));
#undef LFM_CHECK
#undef LFM_TRY
  return 0;
}
