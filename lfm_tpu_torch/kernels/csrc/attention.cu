// C entry point of K1, the port of lfm_tpu/kernels/flash_attention.py::
// attention_small: bf16 runs attention_sm90.cuh; f32 is split by shape, one
// kernel for each (kernels/flash_attention.py's f32_k1_route mirrors it):
// D 128/256 attention_wide.cu (a one-pass kernel at T <= 64, past it
// attention_long_f32.cuh's key-block kernel, the whole row one block); D
// 56-80 at T <= 256 attention_row_f32.cuh, past it the same key-block
// kernel (attention_long_f32.cu).
#include "attention.cuh"

// q, k, v, o: (N, T, H*D) slabs with row strides ldq/ldk/ldv/ldo
// (elements) and batch stride T*ld; bf16 when f32 == 0, float otherwise.
// D: 56-80 in both types, 128 and 256 in float.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int lfm_attention_small(const void* q, const void* k, const void* v, void* o,
                                   int N, int T, int H, int D, int ldq, int ldk, int ldv,
                                   int ldo, int f32, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (f32 && D > 80)
    return static_cast<int>(lfm::launch_attention_wide_f32(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), N, T, H, D, ldq, ldk, ldv, ldo, s));
  if (f32 && T <= 256)
    return static_cast<int>(lfm::launch_attention_row_f32(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), N, T, H, D, ldq, ldk, ldv, ldo, s));
  if (f32)
    return static_cast<int>(lfm::launch_attention_long_f32(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), N, T, H, D, ldq, ldk, ldv, ldo, s));
  using lfm::bf16;
  return static_cast<int>(lfm::launch_attention<false>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), N, T, H, D, ldq, ldk, ldv, ldo, s));
}
