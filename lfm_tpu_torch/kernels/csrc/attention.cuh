// The f32 FMA attention kernel that the origin ADM's wide heads (D 128,
// 256) take past T = 64, the dispatch of the bf16 forward, and the
// declarations of every attention launcher. The port of
// lfm_tpu/kernels/flash_attention.py::attention_small (`_attn_small_kernel`)
// runs, by element type and shape (lfm_attention_small, attention.cu):
//  - bf16 (K1, and the attention inside K2 and K5): the wgmma + TMA kernel
//    of attention_sm90.cuh, through launch_attention<NORM_P> below; bf16 K3
//    is attention_bwd_sm90.cuh;
//  - f32 at D 56-80 (the DiT's heads): the one-pass kernel of
//    attention_row_f32.cuh at T <= 256, the key-block kernel of
//    attention_long_f32.cuh past it, its whole row one block;
//  - f32 at D 128/256 (the origin ADM's attention): attention_wide.cu's
//    one-pass kernel at T <= 64 (celeb256_adm's T = 16 and 64), and past it
//    (a model override that no preset reaches) the kernel below.
// That is a split by shape, not a fallback: each shape has one kernel.
//
// q, k, v are read in place from (N, T, row) slabs: token t of sample n,
// head h starts at ptr[(n*T + t)*ld + h*D]. So the kernel takes the
// (N, T, H*D) layout of the TPU kernel and, with ld = 3C, the three thirds
// of a fused qkv row without any copy or transpose.
//
// One block of 4 warps takes 64 query rows of one (sample, head); each warp
// owns 16 rows. Key and value tiles of 64 rows stream through shared memory.
// Pass 1 computes S = scale * Q K^T tile by tile (f32 accumulation) and keeps
// each row's running max m and sum l = sum exp(s - m) in f32. Pass 2
// recomputes S, forms p = exp(s - m) in f32 and accumulates P V in f32, and
// the f32 result is divided by l at the end (the rounding of
// `_attn_small_kernel`). The (T, T) scores never reach device memory. The
// head dim is zero-padded to DP, a multiple of 16. Its products are f32 FMA
// on the CUDA cores (WarpTile<float, DP> below), so an f32 model is f32
// throughout (no TF32 anywhere).
//
// What bounds it on the H100: at f32, T=256, D=64 the bytes it must move
// are 4*T*H*D*4 per sample against 4*T*T*H*D flops on the 67 TFLOP/s f32
// units: bound by operations. This design recomputes QK^T once (1.5x the
// flops) and does not overlap loads with math; the DiT's heads take the
// kernels of attention_row_f32.cuh and attention_long_f32.cuh, which avoid
// both (at (2, 1024, 16, 64) this kernel took 1.49 ms on an H100 SXM at 700
// W, 8.6% of its bound).
//
// At f32 and DP 256 the q, k and v tiles and the stages would take 277 KB,
// past the 227 KB a block may have, so there v follows k through one tile
// buffer (AttnLayout::KV_SHARE): one more barrier and a serial load per key
// tile.
#pragma once

#include "common.cuh"

namespace lfm {

constexpr int ATT_BQ = 64;        // query rows per block
constexpr int ATT_BK = 64;        // key rows per tile
constexpr int ATT_THREADS = 128;  // 4 warps x 16 query rows
constexpr int ATT_MAX_SMEM = 232448;  // dynamic shared memory a block may use on the H100

template <typename T, int DP>
struct AttnLayout {
  static constexpr int PAD = 16 / int(sizeof(T));            // one 16-byte chunk
  static constexpr int LDT = DP + PAD;                       // tile row (elements)
  static constexpr int LDP = ATT_BK + PAD;                   // P / dS row (elements)
  static constexpr int LDS = (DP > ATT_BK ? DP : ATT_BK) + 4;  // f32 staging row
  static constexpr size_t TILE = size_t(ATT_BQ) * LDT * sizeof(T);
  static constexpr size_t STAGE = size_t(16) * LDS * 4;      // per warp
  static constexpr size_t PBUF = size_t(16) * LDP * sizeof(T);  // per warp
  // the forward's shared memory: q, k and v tiles, then 4 stages and 4 P
  // buffers. Where that is past the card's limit (f32 at DP 256), v
  // follows k through one tile buffer: KV_SHARE.
  static constexpr size_t FWD_ALL = 3 * TILE + 4 * STAGE + 4 * PBUF;
  static constexpr bool KV_SHARE = FWD_ALL > size_t(ATT_MAX_SMEM);
  static constexpr int FWD_TILES = KV_SHARE ? 2 : 3;
  static constexpr size_t FWD_SMEM = FWD_TILES * TILE + 4 * STAGE + 4 * PBUF;
};

// rows [row0, row0+64) x cols [0, DP) of a slab into a tile; rows >= T and
// cols >= D are zero-filled. D * sizeof(T) % 16 == 0.
template <typename T, int DP>
__device__ __forceinline__ void attn_load_tile(T* tile, const T* base, long ld, int row0,
                                               int T_len, int D) {
  constexpr int PAD = AttnLayout<T, DP>::PAD;
  constexpr int CHUNKS = DP / PAD;
  for (int id = threadIdx.x; id < ATT_BQ * CHUNKS; id += ATT_THREADS) {
    int r = id / CHUNKS, c = (id % CHUNKS) * PAD;
    bool ok = (row0 + r < T_len) && (c < D);
    const T* src = ok ? base + long(row0 + r) * ld + c : base;
    cp_async16(tile + r * AttnLayout<T, DP>::LDT + c, src, ok);
  }
  cp_async_commit();
}

// The two per-warp products of the f32 attention kernels, forward and backward.
// Lane layout of the f32 results: lane L owns row L / 2 and the half L % 2
// of the columns.
//   nt:  stage (16 x 64, f32) = A (16 x DP) . B (64 x DP)^T
//   Acc: acc (16 x DP, f32)  += P (16 x 64) . B (64 x DP); store() writes
//        it to stage as 16 x DP.
// A, B are tiles with row stride LDT; P has row stride LDP.
template <typename T, int DP>
struct WarpTile;

template <int DP>
struct WarpTile<float, DP> {
  using L = AttnLayout<float, DP>;
  static constexpr int HALF = DP / 2;

  static __device__ __forceinline__ void nt(const float* a, const float* b, float* stage) {
    const int lane = threadIdx.x % 32, row = lane >> 1, half = lane & 1;
    const float* ar = a + row * L::LDT;
    float s[ATT_BK / 2];
#pragma unroll
    for (int c = 0; c < ATT_BK / 2; ++c) s[c] = 0.0f;
    for (int d = 0; d < DP; ++d) {
      const float av = ar[d];
#pragma unroll
      for (int c = 0; c < ATT_BK / 2; ++c)
        s[c] = fmaf(av, b[(half * (ATT_BK / 2) + c) * L::LDT + d], s[c]);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < ATT_BK / 2; ++c) stage[row * L::LDS + half * (ATT_BK / 2) + c] = s[c];
    __syncwarp();
  }

  struct Acc {
    float f[HALF];

    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int c = 0; c < HALF; ++c) f[c] = 0.0f;
    }
    __device__ __forceinline__ void nn(const float* p, const float* b) {
      const int lane = threadIdx.x % 32, row = lane >> 1, half = lane & 1;
      for (int k = 0; k < ATT_BK; ++k) {
        const float pk = p[row * L::LDP + k];
        const float* br = b + k * L::LDT + half * HALF;
#pragma unroll
        for (int c = 0; c < HALF; ++c) f[c] = fmaf(pk, br[c], f[c]);
      }
    }
    __device__ __forceinline__ void store(float* stage) {
      const int lane = threadIdx.x % 32, row = lane >> 1, half = lane & 1;
      __syncwarp();
#pragma unroll
      for (int c = 0; c < HALF; ++c) stage[row * L::LDS + half * HALF + c] = f[c];
      __syncwarp();
    }
  };
};

// f32, o divided by l at the end (K1's rounding)
template <int DP>
__global__ void __launch_bounds__(ATT_THREADS)
attn_small_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int T_len, int D, long ldq,
                  long ldk, long ldv, long ldo, float scale) {
  using T = float;
  using L = AttnLayout<T, DP>;
  using W = WarpTile<T, DP>;
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
  const int n_tiles = (T_len + ATT_BK - 1) / ATT_BK;

  attn_load_tile<T, DP>(qs, qb, ldq, q0, T_len, D);

  // pass 1: row max and sum of exp, online over key tiles
  float m_run = -INFINITY, l_run = 0.0f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    attn_load_tile<T, DP>(ks, kb, ldk, kt * ATT_BK, T_len, D);
    cp_async_wait<0>();
    __syncthreads();
    W::nt(qw, ks, stage);
    float s[32];
    float mt = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      int col = half * 32 + c;
      s[c] = (kt * ATT_BK + col < T_len) ? scale * stage[row * L::LDS + col] : -INFINITY;
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
  typename W::Acc oacc;
  oacc.zero();
  for (int kt = 0; kt < n_tiles; ++kt) {
    attn_load_tile<T, DP>(ks, kb, ldk, kt * ATT_BK, T_len, D);
    if constexpr (!L::KV_SHARE) attn_load_tile<T, DP>(vs, vb, ldv, kt * ATT_BK, T_len, D);
    cp_async_wait<0>();
    __syncthreads();
    W::nt(qw, ks, stage);
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      int col = half * 32 + c;
      float p = 0.0f;
      if (kt * ATT_BK + col < T_len) p = expf(scale * stage[row * L::LDS + col] - m_run);
      pbuf[row * L::LDP + col] = p;
    }
    __syncwarp();
    if constexpr (L::KV_SHARE) {  // every warp is done with k: v takes its buffer
      __syncthreads();
      attn_load_tile<T, DP>(vs, vb, ldv, kt * ATT_BK, T_len, D);
      cp_async_wait<0>();
      __syncthreads();
    }
    oacc.nn(pbuf, vs);
    __syncthreads();
  }
  oacc.store(stage);
  const int qrow = q0 + warp * 16 + row;
  if (qrow < T_len) {
    T* orow = o + (long(n) * T_len + qrow) * ldo + long(h) * D;
    for (int d = half * (DP / 2); d < (half + 1) * (DP / 2) && d < D; ++d) {
      orow[d] = stage[row * L::LDS + d] * inv_l;
    }
  }
}

template <int DP>
static cudaError_t launch_attn_dp(const float* q, const float* k, const float* v, float* o, int N,
                                  int T_len, int H, int D, long ldq, long ldk, long ldv, long ldo,
                                  cudaStream_t stream) {
  using L = AttnLayout<float, DP>;
  static_assert(L::FWD_SMEM <= size_t(ATT_MAX_SMEM), "attention tiles exceed shared memory");
  auto kernel = attn_small_kernel<DP>;
  const int bytes = int(L::FWD_SMEM);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T_len + ATT_BQ - 1) / ATT_BQ, H, N);
  kernel<<<grid, ATT_THREADS, bytes, stream>>>(q, k, v, o, T_len, D, ldq, ldk, ldv, ldo,
                                               1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

// bf16 attention on Hopper (attention_sm90.cu): bk = 0 takes the whole
// sequence (K1, K2, K5), bk > 0 K4's key blocks
cudaError_t launch_attention_sm90(const bf16* q, const bf16* k, const bf16* v, bf16* o, int N,
                                  int T, int H, int D, long ldq, long ldk, long ldv, long ldo,
                                  int bk, bool norm_p, cudaStream_t stream);

// bf16 attention over whole rows, D in {56, 64, 72, 80} (checked by the
// Python wrapper): the head dims of the DiT configs, 64 (S, B, L) and 72
// (XL). NORM_P: p / l before P V (K2, K5), else o / l at the end (K1).
template <bool NORM_P>
static cudaError_t launch_attention(const bf16* q, const bf16* k, const bf16* v, bf16* o, int N,
                                    int T_len, int H, int D, long ldq, long ldk, long ldv,
                                    long ldo, cudaStream_t s) {
  return launch_attention_sm90(q, k, v, o, N, T_len, H, D, ldq, ldk, ldv, ldo, 0, NORM_P, s);
}

// f32 K1 at D = 128 (celeb256_adm) and 256 (celeb512_adm, church_adm): the
// origin ADM's attention, an f32 island. Compiled in attention_wide.cu.
cudaError_t launch_attention_wide_f32(const float* q, const float* k, const float* v, float* o,
                                      int N, int T_len, int H, int D, long ldq, long ldk,
                                      long ldv, long ldo, cudaStream_t s);

// K3 (attention_bwd.cu): bf16 on Hopper, the wgmma + TMA kernels of
// attention_bwd_sm90.cuh; stats is f32 scratch of 2 * N * H * Tp floats, Tp
// = T rounded up to 64. T <= 1024, D in 8..80 a multiple of 8.
cudaError_t launch_attn_bwd_sm90(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                                 bf16* dq, bf16* dk, bf16* dv, float* stats, int N, int T, int H,
                                 int D, long ldq, long ldk, long ldv, long lddo, long ldg,
                                 cudaStream_t stream);
// f32 K1 at T <= 256, D 8-80 a multiple of 8: the one-pass kernel of
// attention_row_f32.cuh (attention_row_f32.cu).
cudaError_t launch_attention_row_f32(const float* q, const float* k, const float* v, float* o,
                                     int N, int T, int H, int D, long ldq, long ldk, long ldv,
                                     long ldo, cudaStream_t s);
// f32 K3 at T <= 1024, D 8-80 a multiple of 8 (taken past T = 256): the
// dq kernel of attention_long_f32.cuh and the dk/dv kernel of
// attention_row_f32.cuh (attention_bwd_long_f32.cu); stats: 3 * N * H * T
// floats.
cudaError_t launch_attn_bwd_long_f32(const float* q, const float* k, const float* v,
                                     const float* dout, float* dq, float* dk, float* dv,
                                     float* stats, int N, int T, int H, int D, long ldq, long ldk,
                                     long ldv, long lddo, long ldg, cudaStream_t s);
// f32 K4, BK a divisor of T and at most 512, D in {56, 64, 72, 80, 128}:
// the key-block kernel of attention_long_f32.cuh (flash_attention_f32.cu).
// f32 K1 at 256 < T <= 1024, D 8-80 a multiple of 8: the same kernel with
// the whole row one key block (attention_long_f32.cu).
cudaError_t launch_flash_f32(const float* q, const float* k, const float* v, float* o, int N,
                             int T, int H, int D, int BK, long ldq, long ldk, long ldv, long ldo,
                             cudaStream_t s);
cudaError_t launch_attention_long_f32(const float* q, const float* k, const float* v, float* o,
                                      int N, int T, int H, int D, long ldq, long ldk, long ldv,
                                      long ldo, cudaStream_t s);
// f32 K3 at T <= 256, D 8-80 a multiple of 8: the two kernels of
// attention_row_f32.cuh (attention_bwd_row_f32.cu); the same stats layout.
cudaError_t launch_attn_bwd_row_f32(const float* q, const float* k, const float* v,
                                    const float* dout, float* dq, float* dk, float* dv,
                                    float* stats, int N, int T, int H, int D, long ldq, long ldk,
                                    long ldv, long lddo, long ldg, cudaStream_t s);

}  // namespace lfm
