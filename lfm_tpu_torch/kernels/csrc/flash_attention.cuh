// Blocked online-softmax attention for long T (the port of
// lfm_tpu/kernels/flash_attention.py::flash_attention, `_flash_kernel`): K4.
//
// The TPU kernel walks the keys in blocks of BK (512 by default) and keeps,
// per query row, f32 m (running max), l (running sum of exp) and acc (the
// unnormalised output). For each block it takes the block's row max,
// m_new = max(m, block max), p = exp(s - m_new) in f32, alpha =
// exp(m - m_new), l = alpha * l + sum(p), acc = alpha * acc + round(p) V
// with p rounded to v's type and the product accumulated in f32; at the end
// out = acc / l, rounded to the output type. This kernel keeps those
// rounding points and the same blocks of BK keys, so it agrees with its
// plain version (reference_flash_attention) to the order of f32 sums.
//
// Layout and tiles are K1's (attention.cuh): q, k, v are read in place from
// (N, T, row) slabs, one block of 4 warps takes 64 query rows of one
// (sample, head), and key and value tiles of 64 rows stream through shared
// memory; WarpTile does the products (WMMA for bf16, f32 FMA for f32). A
// key block of BK spans BK / 64 tiles: a first sweep computes S tile by
// tile for the block's row max, a second recomputes S, forms p and adds
// P V into a block sum that the lanes then fold into their f32 acc
// registers (lane L owns row L / 2 and half L % 2 of the columns, as in
// K1). So the (T, T) scores never reach device memory, and QK^T is
// computed twice, as in K1.
//
// What bounds it on the H100: at (2, 4096, 16, 64) bf16 the inputs and the
// output are 4 * 2 * 4096 * 16 * 64 * 2 = 34 MB against 4 * N*H*T^2*D =
// 137 GFLOP (without the recompute), about 4,000 flops per byte: bound by
// operations, 0.14 ms at the bf16 peak. This simple design runs WMMA
// (mma.sync), recomputes QK^T and does not overlap loads with math, so it
// is bound by its own latency; wgmma, TMA and one pass per key tile with
// rescaling (FlashAttention-2) are later work.
#pragma once

#include <type_traits>

#include "attention.cuh"

namespace lfm {

template <typename T, int DP>
__global__ void __launch_bounds__(ATT_THREADS)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, int T_len, int D, int BK, long ldq, long ldk, long ldv,
                  long ldo, float scale) {
  using L = AttnLayout<T, DP>;
  using W = WarpTile<T, DP>;
  constexpr int HALF = DP / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + L::TILE);
  T* vs = reinterpret_cast<T*>(smem + (L::FWD_TILES - 1) * L::TILE);  // ks under KV_SHARE
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* stage = reinterpret_cast<float*>(smem + L::FWD_TILES * L::TILE + warp * L::STAGE);
  T* pbuf = reinterpret_cast<T*>(smem + L::FWD_TILES * L::TILE + 4 * L::STAGE + warp * L::PBUF);

  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_BQ;
  const T* qb = q + long(n) * T_len * ldq + long(h) * D;
  const T* kb = k + long(n) * T_len * ldk + long(h) * D;
  const T* vb = v + long(n) * T_len * ldv + long(h) * D;
  const T* qw = qs + warp * 16 * L::LDT;
  const int row = lane >> 1, half = lane & 1;  // two lanes per query row

  attn_load_tile<T, DP>(qs, qb, ldq, q0, T_len, D);

  float m_run = -INFINITY, l_run = 0.0f;  // l_run: this lane's columns
  float acc[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) acc[c] = 0.0f;

  for (int b0 = 0; b0 < T_len; b0 += BK) {
    const int b1 = min(b0 + BK, T_len);  // rows >= b1 are zero-filled and masked
    const int n_tiles = (b1 - b0 + ATT_BK - 1) / ATT_BK;

    // sweep 1: the block's row max
    float mt = -INFINITY;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = b0 + kt * ATT_BK;
      attn_load_tile<T, DP>(ks, kb, ldk, k0, b1, D);
      cp_async_wait<0>();
      __syncthreads();
      W::nt(qw, ks, stage);
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        int col = half * 32 + c;
        if (k0 + col < b1) mt = fmaxf(mt, scale * stage[row * L::LDS + col]);
      }
      __syncthreads();
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m_run, mt);
    const float alpha = expf(m_run - m_new);  // 0 at the first block

    // sweep 2: p = exp(s - m_new), the block's P V in f32
    typename W::Acc pv;
    pv.zero();
    float lsum = 0.0f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = b0 + kt * ATT_BK;
      attn_load_tile<T, DP>(ks, kb, ldk, k0, b1, D);
      if constexpr (!L::KV_SHARE) attn_load_tile<T, DP>(vs, vb, ldv, k0, b1, D);
      cp_async_wait<0>();
      __syncthreads();
      W::nt(qw, ks, stage);
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        int col = half * 32 + c;
        float p = (k0 + col < b1) ? expf(scale * stage[row * L::LDS + col] - m_new) : 0.0f;
        lsum += p;
        pbuf[row * L::LDP + col] = from_f<T>(p);
      }
      __syncwarp();
      if constexpr (L::KV_SHARE) {  // every warp is done with k: v takes its buffer
        __syncthreads();
        attn_load_tile<T, DP>(vs, vb, ldv, k0, b1, D);
        cp_async_wait<0>();
        __syncthreads();
      }
      pv.nn(pbuf, vs);
      __syncthreads();
    }
    pv.store(stage);
    l_run = alpha * l_run + lsum;
#pragma unroll
    for (int c = 0; c < HALF; ++c) acc[c] = alpha * acc[c] + stage[row * L::LDS + half * HALF + c];
    m_run = m_new;
  }

  const float l = l_run + __shfl_xor_sync(0xffffffffu, l_run, 1);
  const int qrow = q0 + warp * 16 + row;
  if (qrow < T_len) {
    T* orow = o + (long(n) * T_len + qrow) * ldo + long(h) * D;
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      const int d = half * HALF + c;
      if (d < D) orow[d] = from_f<T>(acc[c] / l);
    }
  }
}

template <typename T, int DP>
static cudaError_t launch_flash_dp(const T* q, const T* k, const T* v, T* o, int N, int T_len,
                                   int H, int D, int BK, long ldq, long ldk, long ldv, long ldo,
                                   cudaStream_t stream) {
  using L = AttnLayout<T, DP>;
  static_assert(L::FWD_SMEM <= size_t(ATT_MAX_SMEM), "attention tiles exceed shared memory");
  auto kernel = flash_attn_kernel<T, DP>;
  const int bytes = int(L::FWD_SMEM);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T_len + ATT_BQ - 1) / ATT_BQ, H, N);
  kernel<<<grid, ATT_THREADS, bytes, stream>>>(q, k, v, o, T_len, D, BK, ldq, ldk, ldv, ldo,
                                               1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

// D in {56, 64, 72, 80} for both types (the DiT's heads) and 128 for float
// (checked by the Python wrapper); BK >= 1.
template <typename T>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o, int N, int T_len,
                         int H, int D, int BK, long ldq, long ldk, long ldv, long ldo,
                         cudaStream_t s) {
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  auto m = static_cast<T*>(o);
  if (BK < 1) return cudaErrorInvalidValue;
  switch ((D + 15) / 16) {
    case 4: return launch_flash_dp<T, 64>(c(q), c(k), c(v), m, N, T_len, H, D, BK, ldq, ldk, ldv, ldo, s);
    case 5: return launch_flash_dp<T, 80>(c(q), c(k), c(v), m, N, T_len, H, D, BK, ldq, ldk, ldv, ldo, s);
    case 8:
      if constexpr (std::is_same<T, float>::value)
        return launch_flash_dp<T, 128>(c(q), c(k), c(v), m, N, T_len, H, D, BK, ldq, ldk, ldv,
                                       ldo, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace lfm
