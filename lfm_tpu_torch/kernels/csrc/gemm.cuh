// GEMM and LayerNorm pieces shared by K2 (dit_block.cu) and K5
// (dit_block_train.cu): the row-wise LayerNorm + adaLN modulate, the fused
// epilogues, and the two GEMMs.
//
// The NT layout, out (M, N) = A (M, K) . W (N, K)^T (a torch.nn.Linear
// forward: K2, K5's forward, lfm_bf16_mlp), runs on Hopper's wgmma + TMA:
// launch_gemm_nt, the persistent warp-specialised kernel of gemm_sm90.cuh
// (compiled in gemm_sm90.cu). N % 128 == 0, K % 64 == 0; rows m >= M are
// masked.
//
// K5's backward keeps one WMMA GEMM template (gemm_kernel) for the other two
// layouts, tiled 128x128x32: eight warps each compute 64x32 with WMMA bf16
// -> f32 (mma.sync), a two-stage cp.async pipeline, and the epilogue fused
// into the store (all row-major bf16, f32 accumulation):
//   LAYOUT_NN  out (M, N) = A (M, K) . B (K, N)     an activation gradient
//   LAYOUT_TN  out (M, N) = A (K, M)^T . B (K, N)   a weight gradient, summed
//                                                   over all K token rows
// N % 128 == 0 and K % 32 == 0; rows m >= M are masked (NN), TN needs
// M % 128 == 0. Moving them onto wgmma is later work.
#pragma once

#include <type_traits>

#include "common.cuh"

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

// K2's epilogues (0-2), then K5's. The NT GEMM takes all but EPI_DGELU;
// gemm_kernel (NN, TN) takes EPI_STORE and EPI_DGELU:
//   EPI_BIAS       out = value + bias
//   EPI_GELU       out = gelu_tanh(value + bias)
//   EPI_GATED      out = resid + mod[gate] * (value + bias)
//   EPI_GELU_AUX   EPI_GELU, and aux = bf16(value + bias) when aux is set
//   EPI_GATED_AUX  EPI_GATED, aux = bf16(value + bias), aux2 = bf16(out)
//                  when aux2 is set
//   EPI_STORE      out = value (no bias)
//   EPI_DGELU      du = value * gelu_tanh'(u), out = du, and colsum gets the
//                  f32 sums of du over the block's 128 rows (one row of
//                  colsum per blockIdx.y, in a fixed order)
enum { EPI_BIAS = 0, EPI_GELU = 1, EPI_GATED = 2, EPI_GELU_AUX = 3, EPI_GATED_AUX = 4,
       EPI_STORE = 5, EPI_DGELU = 6 };
enum { LAYOUT_NN = 1, LAYOUT_TN = 2 };

struct GemmAux {
  bf16* aux;          // EPI_GELU_AUX, EPI_GATED_AUX
  bf16* aux2;         // EPI_GATED_AUX
  const bf16* u;      // EPI_DGELU: the fc1 pre-activation, (M, N)
  float* colsum;      // EPI_DGELU: (gridDim.y, N)
};

constexpr int GM = 128, GN = 128, GK = 32, GLD = GK + 8, G_THREADS = 256;
constexpr int GLD_KM = GM + 8;  // a (32 x 128) tile stored k-major

constexpr float kGeluA = 0.7978845608028654f, kGeluK = 0.044715f;

__device__ __forceinline__ float gelu_tanh(float u) {
  return 0.5f * u * (1.0f + tanhf(kGeluA * (u + kGeluK * u * u * u)));
}

// d gelu_tanh(u) / du (dit_block_train.py::_gelu_tanh_grad)
__device__ __forceinline__ float gelu_tanh_grad(float u) {
  const float t = tanhf(kGeluA * (u + kGeluK * u * u * u));
  return 0.5f * (1.0f + t) + 0.5f * u * (1.0f - t * t) * (kGeluA * (1.0f + 3.0f * kGeluK * u * u));
}

template <int LAYOUT>
struct GemmTiles {
  static_assert(LAYOUT == LAYOUT_NN || LAYOUT == LAYOUT_TN, "NT runs in gemm_sm90.cuh");
  static constexpr int A_TILE = LAYOUT == LAYOUT_TN ? GK * GLD_KM : GM * GLD;
  static constexpr int B_TILE = GK * GLD_KM;
  using ALayout = typename std::conditional<LAYOUT == LAYOUT_TN, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  using BLayout = nvcuda::wmma::row_major;
  static_assert(A_TILE * 2 >= 8 * 256 * 4, "the epilogue stages its fragments in the A tiles");
};

// out[m, n] = epilogue(sum_k A[m, k] * B[k, n]) with A, B in LAYOUT (above);
// a null bias adds nothing (EPI_STORE and EPI_DGELU never read it).
// EPI_GATED*: resid[m, n] + mod[m / T, gate_idx * N + n] * value.
template <int EPI, typename TRes, typename TOut, int LAYOUT>
__global__ void __launch_bounds__(G_THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const bf16* __restrict__ bias, TOut* __restrict__ out, int M, int N, int K,
            const TRes* __restrict__ resid, const bf16* __restrict__ mod, int gate_idx, int T,
            GemmAux ax) {
  using namespace nvcuda;
  using Tiles = GemmTiles<LAYOUT>;
  __shared__ __align__(128) bf16 as[2][Tiles::A_TILE];
  __shared__ __align__(128) bf16 bs[2][Tiles::B_TILE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;

  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int id = threadIdx.x + i * G_THREADS;  // 512 chunks of 8 bf16 per operand
      if constexpr (LAYOUT == LAYOUT_TN) {   // A^T: 32 k-rows of 128 m
        int r = id >> 4, c = (id & 15) * 8;
        cp_async16(&as[stage][r * GLD_KM + c], A + long(k0 + r) * M + m0 + c, true);
      } else {                               // A: 128 m-rows of 32 k
        int r = id >> 2, c = (id & 3) * 8;
        bool ok = m0 + r < M;
        cp_async16(&as[stage][r * GLD + c], A + (ok ? long(m0 + r) * K + k0 + c : 0), ok);
      }
      {                                      // B: 32 k-rows of 128 n
        int r = id >> 4, c = (id & 15) * 8;
        cp_async16(&bs[stage][r * GLD_KM + c], W + long(k0 + r) * N + n0 + c, true);
      }
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, typename Tiles::ALayout> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, typename Tiles::BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (LAYOUT == LAYOUT_TN)
          wmma::load_matrix_sync(a[i], a_s + kk * GLD_KM + wm * 64 + i * 16, GLD_KM);
        else
          wmma::load_matrix_sync(a[i], a_s + (wm * 64 + i * 16) * GLD + kk, GLD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], b_s + kk * GLD_KM + wn * 32 + j * 16, GLD_KM);
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
  float csum[2] = {0.0f, 0.0f};  // EPI_DGELU: lane < 16 sums column lane of fragment j
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
          float val = scratch[r * 16 + c0 + e];
          if constexpr (EPI == EPI_DGELU) {
            val *= gelu_tanh_grad(to_f(ax.u[o + e]));
            scratch[r * 16 + c0 + e] = val;
          } else if constexpr (EPI != EPI_STORE) {
            if (bias) val += to_f(bias[gn + e]);
          }
          if constexpr (EPI == EPI_GELU_AUX) {
            if (ax.aux) ax.aux[o + e] = from_f<bf16>(val);
          }
          if constexpr (EPI == EPI_GELU || EPI == EPI_GELU_AUX) val = gelu_tanh(val);
          if constexpr (EPI == EPI_GATED || EPI == EPI_GATED_AUX) {
            if constexpr (EPI == EPI_GATED_AUX) ax.aux[o + e] = from_f<bf16>(val);
            val = to_f(resid[o + e]) + to_f(mod[long(gm / T) * 6 * N + long(gate_idx) * N + gn + e]) * val;
            if constexpr (EPI == EPI_GATED_AUX) {
              if (ax.aux2) ax.aux2[o + e] = from_f<bf16>(val);
            }
          }
          out[o + e] = from_f<TOut>(val);
        }
      }
      __syncwarp();
      if constexpr (EPI == EPI_DGELU) {
        if (lane < 16) {
#pragma unroll
          for (int rr = 0; rr < 16; ++rr) csum[j] += scratch[rr * 16 + lane];
        }
        __syncwarp();
      }
    }
  }
  if constexpr (EPI == EPI_DGELU) {
    // the two warps along m add their 64-row sums, in order
    float* part = reinterpret_cast<float*>(&bs[0][0]);  // 2 x 128 floats
    if (lane < 16) {
      part[wm * GN + wn * 32 + lane] = csum[0];
      part[wm * GN + wn * 32 + 16 + lane] = csum[1];
    }
    __syncthreads();
    if (threadIdx.x < GN)
      ax.colsum[long(blockIdx.y) * N + n0 + threadIdx.x] = part[threadIdx.x] + part[GN + threadIdx.x];
  }
}

template <int EPI, typename TRes, typename TOut, int LAYOUT>
static void launch_gemm(const bf16* A, const bf16* W, const bf16* bias, TOut* out, int M, int N,
                        int K, const TRes* resid, const bf16* mod, int gate_idx, int T,
                        cudaStream_t s, GemmAux ax = GemmAux{nullptr, nullptr, nullptr, nullptr}) {
  dim3 grid(N / GN, (M + GM - 1) / GM);
  gemm_kernel<EPI, TRes, TOut, LAYOUT><<<grid, G_THREADS, 0, s>>>(A, W, bias, out, M, N, K, resid,
                                                                  mod, gate_idx, T, ax);
}

// The NT GEMM on wgmma + TMA (gemm_sm90.cu): out (M, N) = epilogue(A (M, K)
// . W (N, K)^T) with one of EPI_BIAS, EPI_GELU, EPI_GATED, EPI_GELU_AUX,
// EPI_GATED_AUX, EPI_STORE (ax.aux and ax.aux2 may be null). Built for
// EPI_BIAS, EPI_STORE and EPI_GELU* into bf16, EPI_GATED* with a bf16 resid
// into f32 and an f32 resid into bf16; anything else, N % 128 != 0 or K % 64
// != 0 returns cudaErrorInvalidValue and launches nothing.
cudaError_t launch_gemm_nt(int epi, const bf16* A, const bf16* W, const bf16* bias, void* out,
                           bool out_f32, const void* resid, bool resid_f32, const bf16* mod,
                           int gate_idx, int T, bf16* aux, bf16* aux2, int M, int N, int K,
                           cudaStream_t s);

template <int EPI, typename TRes, typename TOut>
cudaError_t launch_gemm_nt(const bf16* A, const bf16* W, const bf16* bias, TOut* out, int M,
                           int N, int K, const TRes* resid, const bf16* mod, int gate_idx, int T,
                           cudaStream_t s,
                           GemmAux ax = GemmAux{nullptr, nullptr, nullptr, nullptr}) {
  return launch_gemm_nt(EPI, A, W, bias, out, std::is_same<TOut, float>::value, resid,
                        std::is_same<TRes, float>::value, mod, gate_idx, T, ax.aux, ax.aux2, M,
                        N, K, s);
}

}  // namespace lfm
