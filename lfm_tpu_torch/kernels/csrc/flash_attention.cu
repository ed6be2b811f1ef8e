// C entry point of K4, the port of lfm_tpu/kernels/flash_attention.py::
// flash_attention: bf16 runs attention_sm90.cuh (key-block mode), f32
// attention_long_f32.cuh (flash_attention_f32.cu).
#include "attention.cuh"

// q, k, v, o: (N, T, H*D) slabs with row strides ldq/ldk/ldv/ldo
// (elements) and batch stride T*ld; keys in blocks of bk (a divisor of T;
// at most 512 in f32); bf16 when f32 == 0, float otherwise. Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int lfm_flash_attention(const void* q, const void* k, const void* v, void* o, int N,
                                   int T, int H, int D, int bk, int ldq, int ldk, int ldv,
                                   int ldo, int f32, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (f32)
    return static_cast<int>(lfm::launch_flash_f32(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), N, T, H, D, bk, ldq, ldk, ldv, ldo,
        s));
  if (bk < 1) return static_cast<int>(cudaErrorInvalidValue);
  using lfm::bf16;
  return static_cast<int>(lfm::launch_attention_sm90(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), N, T, H, D, ldq, ldk, ldv, ldo, bk, false, s));
}
