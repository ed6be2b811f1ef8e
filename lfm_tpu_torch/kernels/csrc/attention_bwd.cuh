// K3: the backward of whole-sequence attention for small T, the port of
// lfm_tpu/kernels/flash_attention.py::attention_small_bwd
// (`_attn_small_bwd_kernel`). Per (sample, head), with s = scale q k^T:
//   p  = softmax(s)                        (f32)
//   dv = p^T do                            (p rounded to the input type)
//   dp = do v^T                            (f32)
//   ds = p * (dp - rowsum(dp * p))         (f32, then rounded to the input type)
//   dq = scale ds k,  dk = scale ds^T q    (f32 accumulation)
// The probs are recomputed from q and k and never reach device memory.
//
// Two kernels on one stream, the FlashAttention-2 split, with no atomics,
// so the result is deterministic:
//  1. attn_bwd_dq_kernel, one block per 64 query rows of one (sample,
//     head), 4 warps of 16 rows, as the forward. Pass 1 runs over the key
//     tiles and keeps each row's max m, sum l = sum exp(s - m) and
//     sum exp(s - m) * dp online (rescaled when m grows), which gives
//     delta = rowsum(dp * p) at the end. Pass 2 recomputes s and dp, forms ds
//     and accumulates dq = ds k. It writes dq and the row statistics
//     (m, l, delta) in f32 for the second kernel.
//  2. attn_bwd_dkdv_kernel, one block per 64 key rows, each warp 16 keys.
//     It loops over the query tiles, recomputes s^T = k q^T and dp^T = v do^T
//     for its keys, forms p^T and ds^T from the row statistics and
//     accumulates dv = p^T do and dk = ds^T q in registers.
// q, k, v, do are read in place from (N, T, row) slabs with any row stride
// (the thirds of a fused qkv row); dq, dk, dv are written the same way, so
// the three land in one (N, T, 3C) buffer, the gradient of the qkv Linear.
//
// Each element type is compiled in its own translation unit
// (attention_bwd.cu for bf16 with the C entry point, attention_bwd_f32.cu),
// so that the two compile in parallel.
//
// What bounds it on the H100: the JAX cost model counts 10 T^2 D flops per
// (sample, head) against 7 T H D elements moved, ~180 flops per byte at
// T=256, D=64 in bf16, under the card's ~295: memory in principle. This
// simple design does 18 T^2 D flops (s and dp are computed in both kernels),
// WMMA (mma.sync) bf16 tiles rather than wgmma, and no overlap of loads with
// math, so it is bound by its own latency. f32 runs its products as f32 FMA
// on the CUDA cores (no TF32).
#pragma once
#include "attention.cuh"

namespace lfm {

template <typename T, int DP>
__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ stats,
                   int T_len, int H, int D, long ldq, long ldk, long ldv, long lddo, long ldg,
                   float scale) {
  using L = AttnLayout<T, DP>;
  using W = WarpTile<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + L::TILE);
  T* ks = reinterpret_cast<T*>(smem + 2 * L::TILE);
  T* vs = reinterpret_cast<T*>(smem + 3 * L::TILE);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* stage = reinterpret_cast<float*>(smem + 4 * L::TILE + warp * L::STAGE);
  T* pbuf = reinterpret_cast<T*>(smem + 4 * L::TILE + 4 * L::STAGE + warp * L::PBUF);

  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_BQ;
  const T* qb = q + long(n) * T_len * ldq + long(h) * D;
  const T* kb = k + long(n) * T_len * ldk + long(h) * D;
  const T* vb = v + long(n) * T_len * ldv + long(h) * D;
  const T* db = dout + long(n) * T_len * lddo + long(h) * D;
  const T* qw = qs + warp * 16 * L::LDT;
  const T* dw = dos + warp * 16 * L::LDT;
  const int row = lane >> 1, half = lane & 1;  // two lanes per query row
  const int n_tiles = (T_len + ATT_BK - 1) / ATT_BK;

  attn_load_tile<T, DP>(qs, qb, ldq, q0, T_len, D);
  attn_load_tile<T, DP>(dos, db, lddo, q0, T_len, D);

  // pass 1: m, l and sum exp(s - m) * dp, online over the key tiles
  float m_run = -INFINITY, l_run = 0.0f, pd_run = 0.0f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    attn_load_tile<T, DP>(ks, kb, ldk, kt * ATT_BK, T_len, D);
    attn_load_tile<T, DP>(vs, vb, ldv, kt * ATT_BK, T_len, D);
    cp_async_wait<0>();
    __syncthreads();
    W::nt(qw, ks, stage);
    float e[32];
    float mt = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      int col = half * 32 + c;
      e[c] = (kt * ATT_BK + col < T_len) ? scale * stage[row * L::LDS + col] : -INFINITY;
      mt = fmaxf(mt, e[c]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m_run, mt);
#pragma unroll
    for (int c = 0; c < 32; ++c) e[c] = expf(e[c] - m_new);
    W::nt(dw, vs, stage);  // dp = do v^T
    float sl = 0.0f, spd = 0.0f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      sl += e[c];
      spd += e[c] * stage[row * L::LDS + half * 32 + c];
    }
    const float corr = expf(m_run - m_new);
    l_run = l_run * corr + sl;
    pd_run = pd_run * corr + spd;
    m_run = m_new;
    __syncthreads();
  }
  const float l = l_run + __shfl_xor_sync(0xffffffffu, l_run, 1);
  const float delta = (pd_run + __shfl_xor_sync(0xffffffffu, pd_run, 1)) / l;
  const int qrow = q0 + warp * 16 + row;
  if (half == 0 && qrow < T_len) {
    const long nht = long(gridDim.z) * H * T_len;
    const long at = (long(n) * H + h) * T_len + qrow;
    stats[at] = m_run;
    stats[nht + at] = l;
    stats[2 * nht + at] = delta;
  }

  // pass 2: ds = p * (dp - delta), dq += ds k
  typename W::Acc acc;
  acc.zero();
  for (int kt = 0; kt < n_tiles; ++kt) {
    attn_load_tile<T, DP>(ks, kb, ldk, kt * ATT_BK, T_len, D);
    attn_load_tile<T, DP>(vs, vb, ldv, kt * ATT_BK, T_len, D);
    cp_async_wait<0>();
    __syncthreads();
    W::nt(qw, ks, stage);
    float p[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      int col = half * 32 + c;
      p[c] = (kt * ATT_BK + col < T_len)
                 ? expf(scale * stage[row * L::LDS + col] - m_run) / l : 0.0f;
    }
    W::nt(dw, vs, stage);
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      int col = half * 32 + c;
      pbuf[row * L::LDP + col] = from_f<T>(p[c] * (stage[row * L::LDS + col] - delta));
    }
    __syncwarp();
    acc.nn(pbuf, ks);
    __syncthreads();
  }
  acc.store(stage);
  if (qrow < T_len) {
    T* out = dq + (long(n) * T_len + qrow) * ldg + long(h) * D;
    for (int d = half * (DP / 2); d < (half + 1) * (DP / 2) && d < D; ++d)
      out[d] = from_f<T>(scale * stage[row * L::LDS + d]);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
                     const float* __restrict__ stats, int T_len, int H, int D, long ldq,
                     long ldk, long ldv, long lddo, long ldg, float scale) {
  using L = AttnLayout<T, DP>;
  using W = WarpTile<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + L::TILE);
  T* qs = reinterpret_cast<T*>(smem + 2 * L::TILE);
  T* dos = reinterpret_cast<T*>(smem + 3 * L::TILE);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* stage = reinterpret_cast<float*>(smem + 4 * L::TILE + warp * L::STAGE);
  T* pbuf = reinterpret_cast<T*>(smem + 4 * L::TILE + 4 * L::STAGE + warp * L::PBUF);
  float* ms = reinterpret_cast<float*>(smem + 4 * L::TILE + 4 * L::STAGE + 4 * L::PBUF);
  float* ls = ms + ATT_BQ;
  float* dls = ls + ATT_BQ;

  const int n = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * ATT_BK;
  const T* qb = q + long(n) * T_len * ldq + long(h) * D;
  const T* kb = k + long(n) * T_len * ldk + long(h) * D;
  const T* vb = v + long(n) * T_len * ldv + long(h) * D;
  const T* db = dout + long(n) * T_len * lddo + long(h) * D;
  const long nht = long(gridDim.z) * H * T_len;
  const float* st = stats + (long(n) * H + h) * T_len;
  const T* kw = ks + warp * 16 * L::LDT;
  const T* vw = vs + warp * 16 * L::LDT;
  const int row = lane >> 1, half = lane & 1;  // two lanes per key row
  const int n_tiles = (T_len + ATT_BQ - 1) / ATT_BQ;

  attn_load_tile<T, DP>(ks, kb, ldk, k0, T_len, D);
  attn_load_tile<T, DP>(vs, vb, ldv, k0, T_len, D);

  typename W::Acc dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * ATT_BQ;
    attn_load_tile<T, DP>(qs, qb, ldq, q0, T_len, D);
    attn_load_tile<T, DP>(dos, db, lddo, q0, T_len, D);
    for (int i = threadIdx.x; i < ATT_BQ; i += ATT_THREADS) {
      const bool ok = q0 + i < T_len;
      ms[i] = ok ? st[q0 + i] : 0.0f;
      ls[i] = ok ? st[nht + q0 + i] : 1.0f;
      dls[i] = ok ? st[2 * nht + q0 + i] : 0.0f;
    }
    cp_async_wait<0>();
    __syncthreads();
    W::nt(kw, qs, stage);  // s^T: 16 keys x 64 queries
    float p[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      int col = half * 32 + c;
      p[c] = (q0 + col < T_len)
                 ? expf(scale * stage[row * L::LDS + col] - ms[col]) / ls[col] : 0.0f;
      pbuf[row * L::LDP + col] = from_f<T>(p[c]);
    }
    __syncwarp();
    dv_acc.nn(pbuf, dos);  // dv += p^T do
    W::nt(vw, dos, stage);  // dp^T = v do^T
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      int col = half * 32 + c;
      pbuf[row * L::LDP + col] = from_f<T>(p[c] * (stage[row * L::LDS + col] - dls[col]));
    }
    __syncwarp();
    dk_acc.nn(pbuf, qs);  // dk += ds^T q
    __syncthreads();
  }
  const int krow = k0 + warp * 16 + row;
  dv_acc.store(stage);
  if (krow < T_len) {
    T* out = dv + (long(n) * T_len + krow) * ldg + long(h) * D;
    for (int d = half * (DP / 2); d < (half + 1) * (DP / 2) && d < D; ++d)
      out[d] = from_f<T>(stage[row * L::LDS + d]);
  }
  dk_acc.store(stage);
  if (krow < T_len) {
    T* out = dk + (long(n) * T_len + krow) * ldg + long(h) * D;
    for (int d = half * (DP / 2); d < (half + 1) * (DP / 2) && d < D; ++d)
      out[d] = from_f<T>(scale * stage[row * L::LDS + d]);
  }
}

template <typename T, int DP>
static cudaError_t launch_attn_bwd_dp(const T* q, const T* k, const T* v, const T* dout, T* dq,
                                      T* dk, T* dv, float* stats, int N, int T_len, int H, int D,
                                      long ldq, long ldk, long ldv, long lddo, long ldg,
                                      cudaStream_t stream) {
  using L = AttnLayout<T, DP>;
  const int bytes_dq = int(4 * L::TILE + 4 * L::STAGE + 4 * L::PBUF);
  const int bytes_dkdv = bytes_dq + 3 * ATT_BQ * int(sizeof(float));
  auto k_dq = attn_bwd_dq_kernel<T, DP>;
  auto k_dkdv = attn_bwd_dkdv_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_dkdv);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(float(D));
  dim3 grid((T_len + ATT_BQ - 1) / ATT_BQ, H, N);
  k_dq<<<grid, ATT_THREADS, bytes_dq, stream>>>(q, k, v, dout, dq, stats, T_len, H, D, ldq, ldk,
                                                ldv, lddo, ldg, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k_dkdv<<<grid, ATT_THREADS, bytes_dkdv, stream>>>(q, k, v, dout, dk, dv, stats, T_len, H, D,
                                                    ldq, ldk, ldv, lddo, ldg, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                                   void* dq, void* dk, void* dv, float* stats, int N, int T_len,
                                   int H, int D, long ldq, long ldk, long ldv, long lddo,
                                   long ldg, cudaStream_t s) {
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  auto m = [](void* p) { return static_cast<T*>(p); };
  switch ((D + 15) / 16) {
    case 4:
      return launch_attn_bwd_dp<T, 64>(c(q), c(k), c(v), c(dout), m(dq), m(dk), m(dv), stats, N,
                                       T_len, H, D, ldq, ldk, ldv, lddo, ldg, s);
    case 5:
      return launch_attn_bwd_dp<T, 80>(c(q), c(k), c(v), c(dout), m(dq), m(dk), m(dv), stats, N,
                                       T_len, H, D, ldq, ldk, ldv, lddo, ldg, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace lfm
