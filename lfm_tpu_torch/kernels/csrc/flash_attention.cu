// C entry point of K4, the port of lfm_tpu/kernels/flash_attention.py::
// flash_attention. The kernel is in flash_attention.cuh.
#include "flash_attention.cuh"

namespace lfm {
// compiled here for bf16; the float instance is in flash_attention_f32.cu
template cudaError_t launch_flash<bf16>(const void*, const void*, const void*, void*, int, int,
                                        int, int, int, long, long, long, long, cudaStream_t);
extern template cudaError_t launch_flash<float>(const void*, const void*, const void*, void*,
                                                int, int, int, int, int, long, long, long, long,
                                                cudaStream_t);
}  // namespace lfm

// q, k, v, o: (N, T, H*D) slabs with row strides ldq/ldk/ldv/ldo
// (elements) and batch stride T*ld; keys in blocks of bk; bf16 when
// f32 == 0, float otherwise. Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int lfm_flash_attention(const void* q, const void* k, const void* v, void* o, int N,
                                   int T, int H, int D, int bk, int ldq, int ldk, int ldv,
                                   int ldo, int f32, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (f32)
    return static_cast<int>(
        lfm::launch_flash<float>(q, k, v, o, N, T, H, D, bk, ldq, ldk, ldv, ldo, s));
  return static_cast<int>(
      lfm::launch_flash<lfm::bf16>(q, k, v, o, N, T, H, D, bk, ldq, ldk, ldv, ldo, s));
}
