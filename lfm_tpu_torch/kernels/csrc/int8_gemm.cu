// P1: the port of tools/microbench_int8_pallas.py's two Pallas kernels and
// the w8a8 DiT path they model (lfm_tpu/nn/dit_int8.py).
//
// `_kernel_int8` (run_int8) chains CHAIN times: per-row int8 quantization,
// an s8 x s8 -> s32 product, the f32 dequant, tanh-GELU, per-row
// quantization again, a second s8 product and its dequant. On the TPU it
// keeps 1024 rows x 4096 of hidden in VMEM; a Hopper SM has 227 KB, so here
// it is two kernels that the wrappers chain (kernels/int8_matmul.py):
//
//   quant_rows_kernel      one block per row: m = max|x|, s = max(m, 1e-8) /
//                          127, q = clip(rint(x / s), -127, 127) (half to
//                          even, true divisions: the path's _quant_rows,
//                          dit_int8.py:121)
//   int8_gemm_sm90_kernel  out[m, n] = epilogue(sum_k qa[m, k] * qw[n, k]),
//                          the epilogue in JAX's f32 order: float(acc) *
//                          sa[m] * sw[n], + float(bias[n]), optionally
//                          tanh-GELU, stored as f32 or bf16 (dit_int8.py:
//                          130-140, 215, 223); int8_gemm_sm90.cuh, a
//                          persistent, warp-specialised s8 wgmma + TMA GEMM
//
// The weights are int8 (out, in), K contiguous: the K-major B operand of s8
// wgmma and the torch.nn.Linear layout (JAX's q is (in, out)). This file
// holds the row quantization, the GEMM's launcher (its tile width by N) and the C entries. No fast math: a quantization tie that flips
// moves an int8 value by one step.
//
// fc1's row quantization needs the max over all hidden columns, which cross
// N-tiles: the GEMM writes f32 gelu(h1) and quant_rows_kernel reads it again.
// At the path's N = 200 (51200 rows x 4096) that is 839 MB written and read
// per block and evaluation, the price of a right design without a grid-wide
// reduction; the hidden is not rounded to bf16 to save it (JAX quantizes the
// f32 values).
//
// `_kernel_bf16` (run_bf16), the probe's yardstick, is lfm_bf16_mlp: two
// launches of the bf16 NT GEMM that K2 uses (gemm_sm90.cuh, wgmma + TMA),
// EPI_GELU with no bias into a bf16 hidden (the f32 GELU rounded to bf16
// before the second product) and EPI_STORE into a bf16 out (the f32 product
// rounded when the next chain step reads it).
#include "int8_gemm_sm90.cuh"

namespace lfm {

constexpr int QR_THREADS = 256;

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < QR_THREADS / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// x (M, K) in T -> q (M, K) int8, s (M) f32
template <typename T>
__global__ void __launch_bounds__(QR_THREADS)
quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s, int K) {
  __shared__ float red[QR_THREADS / 32];
  const long row = blockIdx.x;
  const T* xr = x + row * K;
  float m = 0.0f;
  for (int c = threadIdx.x; c < K; c += QR_THREADS) m = fmaxf(m, fabsf(to_f(xr[c])));
  m = block_max(m, red);
  const float sc = __fdiv_rn(fmaxf(m, 1e-8f), 127.0f);
  if (threadIdx.x == 0) s[row] = sc;
  int8_t* qr = q + row * K;
  for (int c = threadIdx.x; c < K; c += QR_THREADS) {
    const float v = rintf(__fdiv_rn(to_f(xr[c]), sc));
    qr[c] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
}

namespace {

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int BN, bool GELU, typename TOut>
cudaError_t launch_tile(const int8_t* A, const int8_t* W, void* out, const sm90::Int8Args& g,
                        cudaStream_t s) {
  using R = sm90::Int8Ring<BN>;
  auto kernel = sm90::int8_gemm_sm90_kernel<BN, GELU, TOut>;
  // the attribute first: the maps' encoder needs the context it makes current
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         R::SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // operands: 128-column k steps; the output: boxes of a consumer's 64 rows
  CUtensorMap ta, tw, t_out;
  if ((err = sm90::matrix_map(&ta, A, g.M, g.K, R::TILE_M)) != cudaSuccess ||
      (err = sm90::matrix_map(&tw, W, g.N, g.K, BN)) != cudaSuccess ||
      (err = sm90::matrix_map(&t_out, static_cast<const TOut*>(out), g.M, g.N, 64)) !=
          cudaSuccess)
    return err;
  const int tiles = (g.M + R::TILE_M - 1) / R::TILE_M * (g.N / BN);
  kernel<<<tiles < sms ? tiles : sms, sm90::GEMM_THREADS, R::SMEM, s>>>(ta, tw, t_out, g);
  return cudaGetLastError();
}

// 256 columns a tile where N % 256 == 0, else 128
// (kernels/int8_matmul.py::int8_gemm_tile states the same rule)
template <bool GELU, typename TOut>
cudaError_t launch_by_n(const int8_t* A, const int8_t* W, void* out, const sm90::Int8Args& g,
                        cudaStream_t s) {
  if (g.N % 256 == 0) return launch_tile<256, GELU, TOut>(A, W, out, g, s);
  return launch_tile<128, GELU, TOut>(A, W, out, g, s);
}

// out = epilogue(A . W^T); refuses N % 128, K % 64, M < 1 and misaligned
// pointers
cudaError_t launch_int8_gemm(const int8_t* A, const int8_t* W, const float* sa, const float* sw,
                             const bf16* bias, void* out, int M, int N, int K, bool gelu,
                             bool out_f32, cudaStream_t s) {
  if (M < 1 || N < 128 || N % 128 || K < 64 || K % 64 || !aligned(A, 16) || !aligned(W, 16) ||
      !aligned(out, 16) || !aligned(sw, 8) || !aligned(bias, 4) || !aligned(sa, 4))
    return cudaErrorInvalidValue;
  const sm90::Int8Args g{sa, sw, bias, M, N, K};
  if (gelu && out_f32) return launch_by_n<true, float>(A, W, out, g, s);
  if (gelu) return launch_by_n<true, bf16>(A, W, out, g, s);
  if (out_f32) return launch_by_n<false, float>(A, W, out, g, s);
  return launch_by_n<false, bf16>(A, W, out, g, s);
}

}  // namespace
}  // namespace lfm

// x: (M, K) bf16 when f32 == 0, float otherwise; q: (M, K) int8; s: M
// floats. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int lfm_quant_rows(const void* x, void* q, void* s, int M, int K, int f32,
                              void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<int8_t*>(q);
  auto sp = static_cast<float*>(s);
  if (f32)
    lfm::quant_rows_kernel<float><<<M, lfm::QR_THREADS, 0, st>>>(static_cast<const float*>(x),
                                                                 qp, sp, K);
  else
    lfm::quant_rows_kernel<lfm::bf16><<<M, lfm::QR_THREADS, 0, st>>>(
        static_cast<const lfm::bf16*>(x), qp, sp, K);
  return static_cast<int>(cudaGetLastError());
}

// a: (M, K) int8 with row scales sa (M floats); w: (N, K) int8 with column
// scales sw (N floats); bias: N bf16 or null; out: (M, N) float when
// out_f32, bf16 otherwise; gelu applies tanh-GELU after the bias. N % 128 ==
// 0, K % 64 == 0. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int lfm_int8_gemm(const void* a, const void* w, const void* sa, const void* sw,
                             const void* bias, void* out, int M, int N, int K, int gelu,
                             int out_f32, void* stream) {
  return static_cast<int>(lfm::launch_int8_gemm(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(sa), static_cast<const float*>(sw),
      static_cast<const lfm::bf16*>(bias), out, M, N, K, gelu != 0, out_f32 != 0,
      static_cast<cudaStream_t>(stream)));
}

// One step of `_kernel_bf16`: x (M, D) bf16, w1 (H, D) and w2 (D, H) bf16 in
// torch.nn.Linear layout; h (M, H) bf16 scratch; out (M, D) bf16 =
// bf16(bf16(gelu(x w1^T)) w2^T). D % 128 == 0, H % 128 == 0. Launches
// two GEMMs on `stream`, allocates nothing, returns the first error.
extern "C" int lfm_bf16_mlp(const void* x, const void* w1, const void* w2, void* h, void* out,
                            int M, int D, int H, void* stream) {
  using lfm::bf16;
  auto st = static_cast<cudaStream_t>(stream);
  auto bp = [](const void* p) { return static_cast<const bf16*>(p); };
  cudaError_t e = lfm::launch_gemm_nt<lfm::EPI_GELU, bf16, bf16>(
      bp(x), bp(w1), nullptr, static_cast<bf16*>(h), M, H, D, nullptr, nullptr, 0, 1, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(lfm::launch_gemm_nt<lfm::EPI_STORE, bf16, bf16>(
      static_cast<const bf16*>(h), bp(w2), nullptr, static_cast<bf16*>(out), M, D, H, nullptr,
      nullptr, 0, 1, st));
}
