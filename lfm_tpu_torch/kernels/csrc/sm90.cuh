// Hopper (sm_90a) pieces shared by the port's wgmma + TMA kernels: the bf16
// attention (attention_sm90.cuh, attention_bwd_sm90.cuh), the NT GEMM of
// K2 and K5's forward (gemm_sm90.cuh) and P1's int8 GEMM
// (int8_gemm_sm90.cuh). mbarriers, TMA loads, the wgmma fences and
// shared-memory descriptors, register rebalancing, and the tensor-map
// encoder looked up at run time with the 2-D row-major maps built on it.
#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's types; the encoder is found at run time

#include "common.cuh"

namespace lfm {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 2-D map at (column c0, row r0), counted on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(r0)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// returns once at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// after the wait: the accumulators are read only from here on
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// a warpgroup's registers per thread, moved between warpgroups (all four
// warps execute it; the kernel's launch bounds set the starting count)
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma shared-memory matrix descriptor, as two 32-bit words. Low: start
// address and leading byte offset (16-byte units); high: stride byte offset
// and swizzle layout (1: 128-byte, 3: 32-byte), one constant for every
// operand of a kernel (base offset 0: every swizzle atom starts aligned). A
// descriptor passed as one 64-bit operand would hold two registers while
// live; the low words take one.
__device__ __forceinline__ uint32_t desc_lo_bits(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16);
}
__host__ __device__ constexpr uint32_t desc_hi_bits(uint32_t sbo, uint64_t layout) {
  return ((sbo >> 4) & 0x3FFF) | uint32_t(layout << 30);
}

// cuTensorMapEncodeTiled, looked up in libcuda at run time (the runtime's
// entry-point query), so that the library links without -lcuda. A launcher
// sets its kernel's attributes before it encodes: that runtime call makes
// the device's context current in a thread new to it, as the encoder needs.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// rows x cols of a row-major matrix as a 2-D map: boxes of 128 bytes of a
// row (128 int8, 64 bf16 or 32 f32) x box_rows rows, 128-byte swizzle; a
// load zero-fills past the last row and column, a store drops what falls
// past them
template <typename T>
inline cudaError_t matrix_map(CUtensorMap* map, const T* ptr, int rows, int cols, int box_rows) {
  static_assert(sizeof(T) == 1 || sizeof(T) == 2 || sizeof(T) == 4, "int8, bf16 or f32");
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * sizeof(T)};
  const cuuint32_t box[2] = {cuuint32_t(128 / sizeof(T)), cuuint32_t(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUtensorMapDataType type = sizeof(T) == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUresult r = encode(map, type, 2, const_cast<T*>(ptr), dims, strides, box, elem_strides,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace lfm
