// P1: the port of tools/microbench_int8_pallas.py's two Pallas kernels and
// the w8a8 DiT path they model (lfm_tpu/nn/dit_int8.py).
//
// `_kernel_int8` (run_int8) chains CHAIN times: per-row int8 quantization,
// an s8 x s8 -> s32 product, the f32 dequant, tanh-GELU, per-row
// quantization again, a second s8 product and its dequant. On the TPU it
// keeps 1024 rows x 4096 of hidden in VMEM; a Hopper SM has 227 KB, so here
// it is two kernels that the wrappers chain (kernels/int8_matmul.py):
//
//   quant_rows_kernel   one block per row: m = max|x|, s = max(m, 1e-8) / 127,
//                       q = clip(rint(x / s), -127, 127) (half to even, true
//                       divisions: the path's _quant_rows, dit_int8.py:121)
//   int8_gemm_kernel    out[m, n] = epilogue(sum_k qa[m, k] * qw[n, k]) with
//                       the epilogue in JAX's f32 order: float(acc) * sa[m] *
//                       sw[n], + float(bias[n]), optionally tanh-GELU,
//                       stored as f32 or bf16 (dit_int8.py:130-140, 215, 223)
//
// The weights are int8 (out, in), K contiguous: the `.col` operand of the s8
// MMA and the torch.nn.Linear layout (JAX's q is (in, out)). The GEMM tiles
// 128 x 128 x 64: eight warps each compute 64 x 32 with WMMA s8 -> s32
// (mma.sync), a two-stage cp.async pipeline, and the epilogue fused into the
// store. Shared memory holds each operand's 64-byte k-slice as four 16-byte
// slabs of 128 rows, so every 16 x 16 fragment starts 256-byte aligned. The
// int32 sums cannot overflow: 127^2 * 4096 < 2^31. The epilogue's products
// and sum are __fmul_rn / __fadd_rn, so that nvcc does not contract them into
// one FMA and the f32 values are JAX's. No fast math: a quantization tie
// that flips moves an int8 value by one step.
//
// fc1's row quantization needs the max over all hidden columns, which cross
// N-tiles: the GEMM writes f32 gelu(h1) and quant_rows_kernel reads it again.
// At the path's N = 200 (51200 rows x 4096) that is 839 MB written and read
// per block and evaluation, the price of a right design without a grid-wide
// reduction; the hidden is not rounded to bf16 to save it (JAX quantizes the
// f32 values).
//
// `_kernel_bf16` (run_bf16), the probe's yardstick, is lfm_bf16_mlp: two of
// gemm.cuh's bf16 WMMA GEMMs, EPI_GELU with no bias into a bf16 hidden (the
// f32 GELU rounded to bf16 before the second product) and EPI_STORE into a
// bf16 out (the f32 product rounded when the next chain step reads it).
//
// What bounds it on the H100: one DiT-L/2 block's four int8 products at
// N = 200, T = 256 are 2 * 51200 * 1024 * 12288 = 1.29 TOP, 0.65 ms at the
// 1979 TOP/s dense int8 peak; the activations they read and write (f32 in,
// f32 or bf16 out, the hidden twice) are ~2.2 GB, 0.66 ms at 3.35 TB/s, so a
// block's int8 path is at the ridge. WMMA's mma.sync reaches a fraction of
// the peak that wgmma + TMA would; those are later work.
#include "gemm.cuh"

namespace lfm {

constexpr int QR_THREADS = 256;

// tanh-GELU in the order and roundings of PyTorch's CUDA kernel
// (ActivationGeluKernel.cu, compiled with FMA contraction): x^3 as (x*x)*x,
// kBeta * fma(kKappa, x^3, x), (0.5*x) * (1 + tanh). The plain version's
// F.gelu then rounds as the epilogue does, and a quantization of the GELU
// output that follows sees the same values on both sides.
__device__ __forceinline__ float gelu_tanh_torch(float x) {
  constexpr float kBeta = 0.7978845608028654f;  // M_SQRT2 * M_2_SQRTPI * 0.5
  constexpr float kKappa = 0.044715f;
  const float x_cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(kBeta, __fmaf_rn(kKappa, x_cube, x));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

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

constexpr int QM = 128, QN = 128, QK = 64;
constexpr int Q_SLAB = 16;                      // bytes of k per slab row
constexpr int Q_SLABS = QK / Q_SLAB;            // 4 slabs per k-tile
constexpr int Q_TILE = QM * QK;                 // 8192 bytes per operand and stage
static_assert(QM == QN, "A and W tiles share one layout");
static_assert(Q_TILE >= 8 * 256 * 4, "the epilogue stages its fragments in the A tiles");

// out[m, n] = epilogue(sum_k A[m, k] * W[n, k]); rows m >= M are masked;
// N % 128 == 0 and K % 64 == 0; bias may be null
template <bool GELU, typename TOut>
__global__ void __launch_bounds__(G_THREADS)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                 const float* __restrict__ sa, const float* __restrict__ sw,
                 const bf16* __restrict__ bias, TOut* __restrict__ out, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(128) int8_t as[2][Q_TILE];
  __shared__ __align__(128) int8_t bs[2][Q_TILE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * QM, n0 = blockIdx.x * QN;

  // 128 rows x 4 slabs of 16 bytes per operand: 512 chunks, two per thread;
  // row r's slab ks lands at ks * 128 * 16 + r * 16
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = threadIdx.x + i * G_THREADS;
      const int r = id >> 2, ks = id & 3;
      const int so = ks * QM * Q_SLAB + r * Q_SLAB;
      const bool ok = m0 + r < M;
      cp_async16(&as[stage][so], A + (ok ? long(m0 + r) * K + k0 + ks * Q_SLAB : 0), ok);
      cp_async16(&bs[stage][so], W + long(n0 + r) * K + k0 + ks * Q_SLAB, true);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int k_tiles = K / QK;
  load_stage(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      load_stage((kt + 1) & 1, (kt + 1) * QK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* a_s = as[kt & 1];
    const int8_t* b_s = bs[kt & 1];
#pragma unroll
    for (int ks = 0; ks < Q_SLABS; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b[2];
      const signed char* a_slab = reinterpret_cast<const signed char*>(a_s) + ks * QM * Q_SLAB;
      const signed char* b_slab = reinterpret_cast<const signed char*>(b_s) + ks * QN * Q_SLAB;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], a_slab + (wm * 64 + i * 16) * Q_SLAB, Q_SLAB);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], b_slab + (wn * 32 + j * 16) * Q_SLAB, Q_SLAB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fragment at a time in the (now
  // idle) A buffers; two lanes per row, 8 contiguous columns each
  int* scratch = reinterpret_cast<int*>(&as[0][0]) + warp * 256;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 64 + i * 16 + r;
      const int gn = n0 + wn * 32 + j * 16 + c0;
      if (gm < M) {
        const long o = long(gm) * N + gn;
        const float s_row = sa[gm];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float val = __fmul_rn(__fmul_rn(__int2float_rn(scratch[r * 16 + c0 + e]), s_row),
                                sw[gn + e]);
          if (bias) val = __fadd_rn(val, to_f(bias[gn + e]));
          if constexpr (GELU) val = gelu_tanh_torch(val);
          out[o + e] = from_f<TOut>(val);
        }
      }
      __syncwarp();
    }
  }
}

template <bool GELU, typename TOut>
static cudaError_t launch_int8_gemm(const int8_t* A, const int8_t* W, const float* sa,
                                    const float* sw, const bf16* bias, void* out, int M, int N,
                                    int K, cudaStream_t s) {
  if (N % QN || K % QK || (M + QM - 1) / QM > 65535) return cudaErrorInvalidValue;
  dim3 grid(N / QN, (M + QM - 1) / QM);
  int8_gemm_kernel<GELU, TOut><<<grid, G_THREADS, 0, s>>>(A, W, sa, sw, bias,
                                                           static_cast<TOut*>(out), M, N, K);
  return cudaGetLastError();
}

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
  auto st = static_cast<cudaStream_t>(stream);
  auto A = static_cast<const int8_t*>(a);
  auto W = static_cast<const int8_t*>(w);
  auto SA = static_cast<const float*>(sa);
  auto SW = static_cast<const float*>(sw);
  auto B = static_cast<const lfm::bf16*>(bias);
  cudaError_t e;
  if (gelu && out_f32)
    e = lfm::launch_int8_gemm<true, float>(A, W, SA, SW, B, out, M, N, K, st);
  else if (gelu)
    e = lfm::launch_int8_gemm<true, lfm::bf16>(A, W, SA, SW, B, out, M, N, K, st);
  else if (out_f32)
    e = lfm::launch_int8_gemm<false, float>(A, W, SA, SW, B, out, M, N, K, st);
  else
    e = lfm::launch_int8_gemm<false, lfm::bf16>(A, W, SA, SW, B, out, M, N, K, st);
  return static_cast<int>(e);
}

// One step of `_kernel_bf16`: x (M, D) bf16, w1 (H, D) and w2 (D, H) bf16 in
// torch.nn.Linear layout; h (M, H) bf16 scratch; out (M, D) bf16 =
// bf16(bf16(gelu(x w1^T)) w2^T). D % 128 == 0, H % 128 == 0. Launches
// two GEMMs on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int lfm_bf16_mlp(const void* x, const void* w1, const void* w2, void* h, void* out,
                            int M, int D, int H, void* stream) {
  using lfm::bf16;
  auto st = static_cast<cudaStream_t>(stream);
  auto bp = [](const void* p) { return static_cast<const bf16*>(p); };
  if (D % lfm::GN || H % lfm::GN || (M + lfm::GM - 1) / lfm::GM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  lfm::launch_gemm<lfm::EPI_GELU, bf16, bf16>(bp(x), bp(w1), nullptr, static_cast<bf16*>(h), M,
                                              H, D, nullptr, nullptr, 0, 1, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lfm::launch_gemm<lfm::EPI_STORE, bf16, bf16>(static_cast<const bf16*>(h), bp(w2), nullptr,
                                               static_cast<bf16*>(out), M, D, H, nullptr, nullptr,
                                               0, 1, st);
  return static_cast<int>(cudaGetLastError());
}
