// The dispatch of the bf16 forward and the declarations of every attention
// launcher. The port of lfm_tpu/kernels/flash_attention.py::attention_small
// (`_attn_small_kernel`) runs, by element type and shape
// (lfm_attention_small, attention.cu):
//  - bf16 (K1, and the attention inside K2 and K5): the wgmma + TMA kernel
//    of attention_sm90.cuh, through launch_attention<NORM_P> below; bf16 K3
//    is attention_bwd_sm90.cuh;
//  - f32 at D 56-80 (the DiT's heads): the one-pass kernel of
//    attention_row_f32.cuh at T <= 256, the key-block kernel of
//    attention_long_f32.cuh past it, its whole row one block;
//  - f32 at D 128/256 (the origin ADM's attention, attention_wide.cu): a
//    one-pass kernel sized to T at T <= 64 (celeb256_adm's T = 16 and 64),
//    and past it (a model override, such as celeb512_adm attending at ds 2
//    and 4) the same key-block kernel of attention_long_f32.cuh; its
//    backward (f32 K3) is attention_bwd_wide_f32.cu at every T.
// That is a split by shape, not a fallback: each shape has one kernel.
//
// q, k, v are read in place from (N, T, row) slabs: token t of sample n,
// head h starts at ptr[(n*T + t)*ld + h*D]. So the kernels take the (N, T,
// H*D) layout of the TPU kernel and, with ld = 3C, the three thirds of a
// fused qkv row without any copy or transpose.
#pragma once

#include "common.cuh"

namespace lfm {

constexpr int ATT_MAX_SMEM = 232448;  // dynamic shared memory a block may use on the H100

// bf16 attention on Hopper (attention_sm90.cu): bk = 0 takes the whole
// sequence (K1, K2, K5), bk > 0 K4's key blocks
cudaError_t launch_attention_sm90(const bf16* q, const bf16* k, const bf16* v, bf16* o, int N,
                                  int T, int H, int D, long ldq, long ldk, long ldv, long ldo,
                                  int bk, bool norm_p, cudaStream_t stream);

// bf16 attention over whole rows, D in {56, 64, 72, 80} (checked by the
// Python wrapper): the head dims of the DiT configs, 64 (S, B, L) and 72
// (XL). NORM_P: p / l before P V (K2, K5), else o / l at the end (K1).
template <bool NORM_P>
static cudaError_t launch_attention(const bf16* q, const bf16* k, const bf16* v, bf16* o, int N,
                                    int T_len, int H, int D, long ldq, long ldk, long ldv,
                                    long ldo, cudaStream_t s) {
  return launch_attention_sm90(q, k, v, o, N, T_len, H, D, ldq, ldk, ldv, ldo, 0, NORM_P, s);
}

// f32 K1 at D = 128 (celeb256_adm) and 256 (celeb512_adm, church_adm), T <=
// 1024: the origin ADM's attention, an f32 island (attention_wide.cu).
cudaError_t launch_attention_wide_f32(const float* q, const float* k, const float* v, float* o,
                                      int N, int T_len, int H, int D, long ldq, long ldk,
                                      long ldv, long ldo, cudaStream_t s);

// K3 (attention_bwd.cu): bf16 on Hopper, the wgmma + TMA kernels of
// attention_bwd_sm90.cuh; stats is f32 scratch of 2 * N * H * Tp floats, Tp
// = T rounded up to 64. T <= 1024, D in 8..80 a multiple of 8.
cudaError_t launch_attn_bwd_sm90(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                                 bf16* dq, bf16* dk, bf16* dv, float* stats, int N, int T, int H,
                                 int D, long ldq, long ldk, long ldv, long lddo, long ldg,
                                 cudaStream_t stream);
// f32 K1 at T <= 256, D 8-80 a multiple of 8: the one-pass kernel of
// attention_row_f32.cuh (attention_row_f32.cu).
cudaError_t launch_attention_row_f32(const float* q, const float* k, const float* v, float* o,
                                     int N, int T, int H, int D, long ldq, long ldk, long ldv,
                                     long ldo, cudaStream_t s);
// f32 K3 at T <= 1024, D 8-80 a multiple of 8 (taken past T = 256): the
// dq kernel of attention_long_f32.cuh and the dk/dv kernel of
// attention_row_f32.cuh (attention_bwd_long_f32.cu); stats: 3 * N * H * T
// floats.
cudaError_t launch_attn_bwd_long_f32(const float* q, const float* k, const float* v,
                                     const float* dout, float* dq, float* dk, float* dv,
                                     float* stats, int N, int T, int H, int D, long ldq, long ldk,
                                     long ldv, long lddo, long ldg, cudaStream_t s);
// f32 K4, BK a divisor of T and at most 512, D in {56, 64, 72, 80, 128}:
// the key-block kernel of attention_long_f32.cuh (flash_attention_f32.cu).
// f32 K1 at 256 < T <= 1024, D 8-80 a multiple of 8: the same kernel with
// the whole row one key block (attention_long_f32.cu; at D 128/256 past T =
// 64, attention_wide.cu).
cudaError_t launch_flash_f32(const float* q, const float* k, const float* v, float* o, int N,
                             int T, int H, int D, int BK, long ldq, long ldk, long ldv, long ldo,
                             cudaStream_t s);
cudaError_t launch_attention_long_f32(const float* q, const float* k, const float* v, float* o,
                                      int N, int T, int H, int D, long ldq, long ldk, long ldv,
                                      long ldo, cudaStream_t s);
// f32 K3 at D = 128 and 256, T <= 1024: the origin ADM's attention
// backward, attention_bwd_wide_f32.cu: one kernel at T <= 64 (48 at D =
// 256; stats unused), past it two with the same stats layout.
cudaError_t launch_attn_bwd_wide_f32(const float* q, const float* k, const float* v,
                                     const float* dout, float* dq, float* dk, float* dv,
                                     float* stats, int N, int T, int H, int D, long ldq, long ldk,
                                     long ldv, long lddo, long ldg, cudaStream_t s);
// f32 K3 at T <= 256, D 8-80 a multiple of 8: the two kernels of
// attention_row_f32.cuh (attention_bwd_row_f32.cu); the same stats layout.
cudaError_t launch_attn_bwd_row_f32(const float* q, const float* k, const float* v,
                                    const float* dout, float* dq, float* dk, float* dv,
                                    float* stats, int N, int T, int H, int D, long ldq, long ldk,
                                    long ldv, long lddo, long ldg, cudaStream_t s);

}  // namespace lfm
