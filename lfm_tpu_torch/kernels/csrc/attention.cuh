// Whole-sequence softmax attention for small T (the port of
// lfm_tpu/kernels/flash_attention.py::attention_small, `_attn_small_kernel`).
//
// q, k, v are read in place from (N, T, row) slabs: token t of sample n,
// head h starts at ptr[(n*T + t)*ld + h*D]. So the kernel takes the
// (N, T, H*D) layout of the TPU kernel and, with ld = 3C, the three thirds
// of a fused qkv row without any copy or transpose.
//
// One block of 4 warps takes 64 query rows of one (sample, head); each warp
// owns 16 rows. Key and value tiles of 64 rows stream through shared memory.
// Pass 1 computes S = scale * Q K^T tile by tile (WMMA bf16 -> f32) and keeps
// each row's running max m and sum l = sum exp(s - m) in f32. Pass 2
// recomputes S, forms p = exp(s - m) in f32, rounds p to bf16 and
// accumulates P V in f32 WMMA fragments. NORM_P = false divides the f32
// result by l at the end (the rounding of `_attn_small_kernel`, K1);
// NORM_P = true rounds p / l before the PV product instead (the rounding of
// `_dit_block_kernel`, the attention inside K2). The (T, T) scores never
// reach device memory. The head dim is zero-padded to DP, a multiple of 16.
//
// What bounds it on the H100: at T=256, D=64 the bytes it must move are
// 4*T*H*D*2 per sample against 4*T*T*H*D flops, about 128 flops per byte,
// under the card's ~295 bf16 flops per byte, so it is bound by memory in
// principle; this simple design recomputes QK^T once (1.5x the flops), uses
// WMMA (mma.sync) rather than wgmma, and does not overlap loads with math,
// so in practice it is bound by its own latency. TMA + wgmma is later work.
#pragma once

#include "common.cuh"

namespace lfm {

constexpr int ATT_BQ = 64;       // query rows per block
constexpr int ATT_BK = 64;       // key rows per tile
constexpr int ATT_THREADS = 128;  // 4 warps x 16 query rows
constexpr int ATT_LDP = ATT_BK + 8;

template <int DP>
struct AttnLayout {
  static constexpr int LDT = DP + 8;                         // bf16 tile row
  static constexpr int LDS = (DP > ATT_BK ? DP : ATT_BK) + 4;  // f32 staging row
  static constexpr size_t TILE = size_t(ATT_BQ) * LDT * 2;
  static constexpr size_t STAGE = size_t(16) * LDS * 4;      // per warp
  static constexpr size_t PBUF = size_t(16) * ATT_LDP * 2;   // per warp
  static constexpr size_t BYTES = 3 * TILE + 4 * STAGE + 4 * PBUF;
};

// rows [row0, row0+64) x cols [col, col+DP) of a slab into a bf16 tile;
// rows >= T and cols >= D are zero-filled. D % 8 == 0.
template <int DP>
__device__ __forceinline__ void attn_load_tile(bf16* tile, const bf16* base, long ld,
                                               int row0, int T, int D) {
  constexpr int CHUNKS = DP / 8;
  for (int id = threadIdx.x; id < ATT_BQ * CHUNKS; id += ATT_THREADS) {
    int r = id / CHUNKS, c = (id % CHUNKS) * 8;
    bool ok = (row0 + r < T) && (c < D);
    const bf16* src = ok ? base + long(row0 + r) * ld + c : base;
    cp_async16(tile + r * AttnLayout<DP>::LDT + c, src, ok);
  }
  cp_async_commit();
}

// this warp's 16 x 64 score tile S = Q_w K^T (unscaled) into stage (f32)
template <int DP>
__device__ __forceinline__ void attn_scores(const bf16* qw, const bf16* ks, float* stage) {
  using namespace nvcuda;
  constexpr int LDT = AttnLayout<DP>::LDT;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[ATT_BK / 16];
#pragma unroll
  for (int j = 0; j < ATT_BK / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, qw + kk * 16, LDT);
#pragma unroll
    for (int j = 0; j < ATT_BK / 16; ++j) {
      // K^T as a column-major (D x keys) operand: element (d, key) at key*LDT + d
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, ks + j * 16 * LDT + kk * 16, LDT);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < ATT_BK / 16; ++j)
    wmma::store_matrix_sync(stage + j * 16, acc[j], AttnLayout<DP>::LDS, wmma::mem_row_major);
  __syncwarp();
}

template <int DP, bool NORM_P>
__global__ void __launch_bounds__(ATT_THREADS)
attn_small_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int T, int D,
                  long ldq, long ldk, long ldv, long ldo, float scale) {
  using namespace nvcuda;
  using L = AttnLayout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::TILE);
  bf16* vs = reinterpret_cast<bf16*>(smem + 2 * L::TILE);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* stage = reinterpret_cast<float*>(smem + 3 * L::TILE + warp * L::STAGE);
  bf16* pbuf = reinterpret_cast<bf16*>(smem + 3 * L::TILE + 4 * L::STAGE + warp * L::PBUF);

  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_BQ;
  const bf16* qb = q + long(n) * T * ldq + long(h) * D;
  const bf16* kb = k + long(n) * T * ldk + long(h) * D;
  const bf16* vb = v + long(n) * T * ldv + long(h) * D;
  const bf16* qw = qs + warp * 16 * L::LDT;
  const int row = lane >> 1, half = lane & 1;  // two lanes per query row
  const int n_tiles = (T + ATT_BK - 1) / ATT_BK;

  attn_load_tile<DP>(qs, qb, ldq, q0, T, D);

  // pass 1: row max and sum of exp, online over key tiles
  float m_run = -INFINITY, l_run = 0.0f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    attn_load_tile<DP>(ks, kb, ldk, kt * ATT_BK, T, D);
    cp_async_wait<0>();
    __syncthreads();
    attn_scores<DP>(qw, ks, stage);
    float s[32];
    float mt = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      int col = half * 32 + c;
      s[c] = (kt * ATT_BK + col < T) ? scale * stage[row * L::LDS + col] : -INFINITY;
      mt = fmaxf(mt, s[c]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    float m_new = fmaxf(m_run, mt);
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 32; ++c) acc += expf(s[c] - m_new);
    l_run = l_run * expf(m_run - m_new) + acc;
    m_run = m_new;
    __syncthreads();
  }
  const float l = l_run + __shfl_xor_sync(0xffffffffu, l_run, 1);
  const float inv_l = 1.0f / l;

  // pass 2: P V with the final row max
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[DP / 16];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(oacc[j], 0.0f);
  for (int kt = 0; kt < n_tiles; ++kt) {
    attn_load_tile<DP>(ks, kb, ldk, kt * ATT_BK, T, D);
    attn_load_tile<DP>(vs, vb, ldv, kt * ATT_BK, T, D);
    cp_async_wait<0>();
    __syncthreads();
    attn_scores<DP>(qw, ks, stage);
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      int col = half * 32 + c;
      float p = 0.0f;
      if (kt * ATT_BK + col < T) {
        p = expf(scale * stage[row * L::LDS + col] - m_run);
        if (NORM_P) p = p / l;
      }
      pbuf[row * ATT_LDP + col] = from_f<bf16>(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < ATT_BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, pbuf + kk * 16, ATT_LDP);
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, vs + kk * 16 * L::LDT + j * 16, L::LDT);
        wmma::mma_sync(oacc[j], a, b, oacc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < DP / 16; ++j)
    wmma::store_matrix_sync(stage + j * 16, oacc[j], L::LDS, wmma::mem_row_major);
  __syncwarp();
  const int qrow = q0 + warp * 16 + row;
  if (qrow < T) {
    bf16* orow = o + (long(n) * T + qrow) * ldo + long(h) * D;
    for (int d = half * (DP / 2); d < (half + 1) * (DP / 2) && d < D; ++d) {
      float val = stage[row * L::LDS + d];
      orow[d] = from_f<bf16>(NORM_P ? val : val * inv_l);
    }
  }
}

template <int DP, bool NORM_P>
static cudaError_t launch_attn_dp(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                                  int N, int T, int H, int D, long ldq, long ldk, long ldv,
                                  long ldo, cudaStream_t stream) {
  auto kernel = attn_small_kernel<DP, NORM_P>;
  const int bytes = int(AttnLayout<DP>::BYTES);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T + ATT_BQ - 1) / ATT_BQ, H, N);
  kernel<<<grid, ATT_THREADS, bytes, stream>>>(q, k, v, o, T, D, ldq, ldk, ldv, ldo,
                                               1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

// D in {56, 64, 72, 80} (checked by the Python wrapper): the head dims of
// the DiT configs, 64 (S, B, L) and 72 (XL). Add a padded size here when a
// config needs it.
template <bool NORM_P>
static cudaError_t launch_attention(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                                    int N, int T, int H, int D, long ldq, long ldk, long ldv,
                                    long ldo, cudaStream_t s) {
  switch ((D + 15) / 16) {
    case 4: return launch_attn_dp<64, NORM_P>(q, k, v, o, N, T, H, D, ldq, ldk, ldv, ldo, s);
    case 5: return launch_attn_dp<80, NORM_P>(q, k, v, o, N, T, H, D, ldq, ldk, ldv, ldo, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace lfm
