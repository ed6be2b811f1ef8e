// C entry point of K3, the port of lfm_tpu/kernels/flash_attention.py::
// attention_small_bwd. The kernels are in attention_bwd.cuh.
#include "attention_bwd.cuh"

namespace lfm {
// compiled here for bf16; the float instance is in attention_bwd_f32.cu
template cudaError_t launch_attn_bwd<bf16>(const void*, const void*, const void*, const void*,
                                           void*, void*, void*, float*, int, int, int, int, long,
                                           long, long, long, long, cudaStream_t);
extern template cudaError_t launch_attn_bwd<float>(const void*, const void*, const void*,
                                                   const void*, void*, void*, void*, float*, int,
                                                   int, int, int, long, long, long, long, long,
                                                   cudaStream_t);
}  // namespace lfm

// q, k, v, dout: (N, T, H*D) slabs with row strides ldq/ldk/ldv/lddo
// (elements); dq, dk, dv: slabs with row stride ldg; stats: 3*N*H*T floats
// of scratch (m, l, delta). bf16 when f32 == 0, float otherwise. Launches
// both kernels on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int lfm_attention_small_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       void* stats, int N, int T, int H, int D, int ldq, int ldk,
                                       int ldv, int lddo, int ldg, int f32, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto st = static_cast<float*>(stats);
  if (f32)
    return static_cast<int>(lfm::launch_attn_bwd<float>(q, k, v, dout, dq, dk, dv, st, N, T, H,
                                                        D, ldq, ldk, ldv, lddo, ldg, s));
  return static_cast<int>(lfm::launch_attn_bwd<lfm::bf16>(q, k, v, dout, dq, dk, dv, st, N, T, H,
                                                          D, ldq, ldk, ldv, lddo, ldg, s));
}
