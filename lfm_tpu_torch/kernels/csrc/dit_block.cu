// K2: one DiT block forward (the port of lfm_tpu/kernels/dit_block.py::
// fused_dit_block, `_dit_block_kernel`), with its bf16 rounding points:
//   h   = bf16(LN(x) * (1 + scale_msa) + shift_msa)          ln_modulate
//   qkv = bf16(h Wqkv^T + bqkv)                               gemm, EPI_BIAS
//   ao  = bf16(softmax(q k^T / sqrt(D)) v), p rounded to bf16 attention.cuh
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
// on one stream: the four GEMMs are tiled 128x128x32, eight warps each
// computing 64x32 with WMMA bf16 -> f32 (mma.sync), a two-stage cp.async
// pipeline, and the bias / GELU / gated-residual epilogues fused into the
// store. The intermediates (h, qkv, ao, x1, u) round-trip device memory,
// which at these sizes is cheap next to the GEMMs. wgmma, TMA and a
// persistent schedule are later work.
#include "attention.cuh"

namespace lfm {

constexpr float kLnEps = 1e-6f;
constexpr int LN_THREADS = 256;

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
  for (int w = 0; w < LN_THREADS / 32; ++w) t += red[w];
  return t;
}

// one block per token row: out = bf16(LN(x) * (1 + mod[scale]) + mod[shift])
template <typename TIn>
__global__ void __launch_bounds__(LN_THREADS)
ln_modulate_kernel(const TIn* __restrict__ x, const bf16* __restrict__ mod,
                   bf16* __restrict__ out, int T, int C, int shift_idx, int scale_idx) {
  __shared__ float red[LN_THREADS / 32];
  const long row = blockIdx.x;
  const TIn* xr = x + row * C;
  float s = 0.0f, ss = 0.0f;
  for (int c = threadIdx.x; c < C; c += LN_THREADS) {
    float v = to_f(xr[c]);
    s += v;
    ss += v * v;
  }
  const float mu = block_sum(s, red) / C;
  const float var = block_sum(ss, red) / C - mu * mu;
  const float r = rsqrtf(var + kLnEps);
  const bf16* m = mod + (row / T) * 6L * C;
  for (int c = threadIdx.x; c < C; c += LN_THREADS) {
    float h = (to_f(xr[c]) - mu) * r;
    out[row * C + c] = from_f<bf16>(h * (1.0f + to_f(m[scale_idx * C + c])) + to_f(m[shift_idx * C + c]));
  }
}

enum { EPI_BIAS = 0, EPI_GELU = 1, EPI_GATED = 2 };

constexpr int GM = 128, GN = 128, GK = 32, GLD = GK + 8, G_THREADS = 256;

__device__ __forceinline__ float gelu_tanh(float u) {
  return 0.5f * u * (1.0f + tanhf(0.7978845608028654f * (u + 0.044715f * u * u * u)));
}

// out[m, n] = epilogue(sum_k A[m, k] * W[n, k] + bias[n]); A (M, K), W (N, K)
// row-major bf16. N % 128 == 0, K % 32 == 0; rows m >= M are masked.
// EPI_GATED: out = resid[m, n] + mod[m / T, gate_idx * N + n] * value.
template <int EPI, typename TRes, typename TOut>
__global__ void __launch_bounds__(G_THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const bf16* __restrict__ bias, TOut* __restrict__ out, int M, int N, int K,
            const TRes* __restrict__ resid, const bf16* __restrict__ mod, int gate_idx, int T) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 as[2][GM * GLD];
  __shared__ __align__(128) bf16 bs[2][GN * GLD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;

  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int id = threadIdx.x + i * G_THREADS;  // 512 chunks of 8 bf16 per operand
      int r = id >> 2, c = (id & 3) * 8;
      bool ok = m0 + r < M;
      cp_async16(&as[stage][r * GLD + c], A + (ok ? long(m0 + r) * K + k0 + c : 0), ok);
      cp_async16(&bs[stage][r * GLD + c], W + long(n0 + r) * K + k0 + c, true);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int k_tiles = K / GK;
  load_stage(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      load_stage((kt + 1) & 1, (kt + 1) * GK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a_s = as[kt & 1];
    const bf16* b_s = bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], a_s + (wm * 64 + i * 16) * GLD + kk, GLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], b_s + (wn * 32 + j * 16) * GLD + kk, GLD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fragment at a time in the (now
  // idle) A buffers; two lanes per row, 8 contiguous columns each
  float* scratch = reinterpret_cast<float*>(&as[0][0]) + warp * 256;
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
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float val = scratch[r * 16 + c0 + e] + to_f(bias[gn + e]);
          if (EPI == EPI_GELU) val = gelu_tanh(val);
          if (EPI == EPI_GATED)
            val = to_f(resid[o + e]) + to_f(mod[long(gm / T) * 6 * N + long(gate_idx) * N + gn + e]) * val;
          out[o + e] = from_f<TOut>(val);
        }
      }
      __syncwarp();
    }
  }
}

template <int EPI, typename TRes, typename TOut>
static void launch_gemm(const bf16* A, const bf16* W, const bf16* bias, TOut* out, int M, int N,
                        int K, const TRes* resid, const bf16* mod, int gate_idx, int T,
                        cudaStream_t s) {
  dim3 grid(N / GN, (M + GM - 1) / GM);
  gemm_kernel<EPI, TRes, TOut><<<grid, G_THREADS, 0, s>>>(A, W, bias, out, M, N, K, resid, mod,
                                                          gate_idx, T);
}

}  // namespace lfm

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
  LFM_CHECK((lfm::ln_modulate_kernel<bf16><<<M, lfm::LN_THREADS, 0, s>>>(bp(x), m, h, T, C, 0, 1)));
  LFM_CHECK((lfm::launch_gemm<lfm::EPI_BIAS, bf16, bf16>(h, bp(wqkv), bp(bqkv), qkv, M, 3 * C, C,
                                                         nullptr, nullptr, 0, T, s)));
  cudaError_t err = lfm::launch_attention<true>(qkv, qkv + C, qkv + 2 * C, ao, N, T, heads, D,
                                                3L * C, 3L * C, 3L * C, C, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  LFM_CHECK((lfm::launch_gemm<lfm::EPI_GATED, bf16, float>(ao, bp(wproj), bp(bproj), x1, M, C, C,
                                                           bp(x), m, 2, T, s)));
  LFM_CHECK((lfm::ln_modulate_kernel<float><<<M, lfm::LN_THREADS, 0, s>>>(x1, m, h, T, C, 3, 4)));
  LFM_CHECK((lfm::launch_gemm<lfm::EPI_GELU, bf16, bf16>(h, bp(w1), bp(b1), u, M, hidden, C,
                                                         nullptr, nullptr, 0, T, s)));
  LFM_CHECK((lfm::launch_gemm<lfm::EPI_GATED, float, bf16>(u, bp(w2), bp(b2),
                                                           static_cast<bf16*>(out), M, C, hidden,
                                                           x1, m, 5, T, s)));
#undef LFM_CHECK
  return 0;
}
