// bf16 K3 for Hopper (sm_90a), on wgmma and TMA: the backward of
// whole-sequence attention, the port of
// lfm_tpu/kernels/flash_attention.py::attention_small_bwd
// (`_attn_small_bwd_kernel`). Per (sample, head), with s = scale q k^T:
//   p  = e / sum(e), e = exp(s - max s)    (f32, normalised)
//   dv = pc^T do                           (pc = p rounded to bf16)
//   dp = do v^T                            (f32)
//   ds = p * (dp - rowsum(dp * p))         (f32, then rounded to bf16)
//   dq = scale ds k,  dk = scale ds^T q    (f32 accumulation)
// at the TPU kernel's rounding points. The probs never reach device memory.
//
// Two kernels on one stream, the FlashAttention-2 split, with no atomics,
// so the result is deterministic:
//  1. attn_bwd_dq_kernel: one warpgroup per CTA takes 64 query rows of one
//     (sample, head). Pass 1 runs over the 64-key tiles: S = Q K^T and
//     dP = dO V^T by wgmma (both operands K-major in shared memory), each
//     row's max m, l = sum exp(s - m) and sum exp(s - m) * dp online
//     (rescaled when m grows; the four threads of a row share m). It writes
//     per row lse = m * scale * log2(e) + log2(l), so that p =
//     exp2(s * scale * log2(e) - lse), and delta = rowsum(dp * p). Pass 2
//     recomputes S and dP, forms ds in registers, rounds it to bf16 straight
//     into wgmma's register-A fragments and accumulates dq += dS K (K as the
//     MN-major B operand, as V in the forward's P V).
//  2. attn_bwd_dkdv_kernel: one warpgroup per 64 keys. K and V stay in
//     shared memory; per 64-query tile S^T = K Q^T and dP^T = V dO^T
//     (K-major), p^T and ds^T from the tile's lse and delta, rounded to bf16
//     into register-A fragments, then dv += P^T dO and dk += dS^T Q (dO and
//     Q MN-major). dv and dk stay in registers until the end.
// K/V tiles (kernel 1) and Q/dO tiles with their 64 lse and delta values
// (kernel 2) go through a ring of STAGES slots filled by TMA, with full and
// empty mbarriers per slot (phase parity = the slot's use count & 1), as in
// the forward's key-block mode (attention_sm90.cuh). The 4-D (D, H, T, N)
// tensor maps zero-fill the columns past D (56 and 72 pad to 64 and 80) and
// the rows past T: a key past T gets s = -inf (p = 0), a query past T gets
// lse = +inf and delta = 0 from kernel 1 (p = ds = 0 in kernel 2).
//
// Layout. q, k, v, do are read in place from (N, T, row) slabs of any row
// stride (the thirds of a fused qkv row); dq, dk, dv are written with row
// stride ldg, so the three land in one (N, T, 3C) buffer. stats: f32 scratch
// of 2 * N * H * Tp floats, Tp = T rounded up to 64: lse then delta for
// each (sample, head), every row up to Tp written by kernel 1, so that
// kernel 2 reads each query tile's 2 x 256 bytes with one bulk copy each.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s). At (32, 256,
// 16, 64) the function moves 7 N T H D * 2 = 117 MB (0.035 ms) and needs
// 10 N H T^2 D = 21.5 GFLOP (0.022 ms): bytes. The split computes 18 T^2 D
// a (sample, head) (S and dP in both kernels and twice in kernel 1), 39
// GFLOP, so at most ~60% of the tensor rate would reach the byte bound.
// Registers and shared memory are sized for three CTAs an SM at D <= 64
// (two at 72/80), so one CTA's TMA loads and softmax overlap the others'
// wgmmas; K and V (kernel 1) or Q and dO (kernel 2) are read through L2
// once per tile of the other side.
#pragma once

#include "attention_sm90.cuh"

namespace lfm {
namespace sm90 {

constexpr int BWD_STAGES = 3;      // ring slots of both kernels
constexpr int BWD_STAT_BYTES = 2 * ROWS * 4;  // a query tile's lse and delta

// 1-D bulk copy of `bytes` (a multiple of 16, 16-byte aligned) counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// the ring of one warpgroup CTA: thread 0 loads item i into slot i %
// BWD_STAGES; each warp releases a slot when done with it, and thread 0
// refills it with item i + BWD_STAGES once all four have
struct BwdRing {
  uint32_t bars;  // full[BWD_STAGES], then empty[BWD_STAGES]
  int items;

  __device__ __forceinline__ uint32_t full(int i) const { return bars + 8 * (i % BWD_STAGES); }
  __device__ __forceinline__ uint32_t empty(int i) const {
    return bars + 8 * (BWD_STAGES + i % BWD_STAGES);
  }
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (BWD_STAGES + s), WG_THREADS / 32);
    }
  }
  __device__ __forceinline__ void wait(int i) const { mbar_wait(full(i), (i / BWD_STAGES) & 1); }
  template <typename Load>
  __device__ __forceinline__ void release(int i, Load&& load_item) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty(i));
    if (threadIdx.x == 0 && i + BWD_STAGES < items) {
      mbar_wait(empty(i), (i / BWD_STAGES) & 1);
      load_item(i + BWD_STAGES);
    }
    __syncwarp();
  }
};

// acc (64 x 64) = A . B^T, A and B 64-row K-major tiles
template <int DP>
__device__ __forceinline__ void wgmma_nt(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss_n64(acc, kmajor_desc<DP>(a, kk), kmajor_desc<DP>(b, kk), desc_hi<DP>(), kk);
}

// acc (64 x DP) += A (64 x 64 keys or queries, register fragments) . B (a
// 64-row tile as the MN-major operand)
template <int DP>
__device__ __forceinline__ void wgmma_rs_acc(float (&acc)[DP / 2], const uint32_t (&a)[4][4],
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) WgmmaRS<DP>::run(acc, a[kk], v_desc<DP>(b, kk), desc_hi<DP>(), 1);
}

template <int R>
__device__ __forceinline__ void zero(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) r[i] = 0.0f;
}

// Kernel 1: dq and the row statistics of 64 query rows of (sample
// blockIdx.z, head blockIdx.y).
template <int DP>
__global__ void __launch_bounds__(WG_THREADS, DP == 64 ? 3 : 2)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   bf16* __restrict__ dq, float* __restrict__ stats, int T, int D, long ldg,
                   float scale, float scale_log2) {
  using B = TileBytes<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t dos = qs + B::TILE, ring = dos + B::TILE;  // slot: K tile, then V tile
  const uint32_t bar_q = ring + BWD_STAGES * 2 * B::TILE;
  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int ntile = (T + ROWS - 1) / ROWS;
  const BwdRing rg{bar_q + 8, 2 * ntile};  // items: pass 1's key tiles, then pass 2's
  const CUtensorMap *mk = &tk, *mv = &tv;
  auto slot = [&](int i) { return ring + (i % BWD_STAGES) * 2 * B::TILE; };
  auto load_item = [&](int i) {
    const int k0 = (i % ntile) * ROWS;
    mbar_expect_tx(rg.full(i), 2 * B::TILE);
    load_tile<DP>(slot(i), mk, rg.full(i), h, k0, n);
    load_tile<DP>(slot(i) + B::TILE, mv, rg.full(i), h, k0, n);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    rg.init();
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, 2 * B::TILE);
    load_tile<DP>(qs, &tq, bar_q, h, q0, n);
    load_tile<DP>(dos, &tdo, bar_q, h, q0, n);
    for (int i = 0; i < BWD_STAGES && i < rg.items; ++i) load_item(i);
  }
  mbar_wait(bar_q, 0);

  // S and dP of item i's key tile
  auto products = [&](float (&s)[32], float (&dp)[32], int i) {
    rg.wait(i);
    wgmma_fence();
    wgmma_nt<DP>(s, qs, slot(i));
    wgmma_nt<DP>(dp, dos, slot(i) + B::TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
  };

  // pass 1: m, l and sum e * dp of this thread's two rows, online
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f, pd0 = 0.0f, pd1 = 0.0f;
  int item = 0;
  for (int j = 0; j < ntile; ++j, ++item) {
    float s[32], dp[32];
    products(s, dp, item);
    rg.release(item, load_item);
    float mx0 = m0, mx1 = m1;
    tile_max(s, j * ROWS, T, mx0, mx1);
    mx0 = quad_max(mx0);  // finite: key 0 < T is in tile 0
    mx1 = quad_max(mx1);
    const float c0 = exp2f((m0 - mx0) * scale_log2), c1 = exp2f((m1 - mx1) * scale_log2);
    const float ms0 = mx0 * scale_log2, ms1 = mx1 * scale_log2;
    float sl0 = 0.0f, sl1 = 0.0f, sp0 = 0.0f, sp1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool r1 = i & 2;
      const float e = exp2f(fmaf(s[i], scale_log2, -(r1 ? ms1 : ms0)));
      if (r1) {
        sl1 += e;
        sp1 = fmaf(e, dp[i], sp1);
      } else {
        sl0 += e;
        sp0 = fmaf(e, dp[i], sp0);
      }
    }
    l0 = fmaf(l0, c0, sl0);
    l1 = fmaf(l1, c1, sl1);
    pd0 = fmaf(pd0, c0, sp0);
    pd1 = fmaf(pd1, c1, sp1);
    m0 = mx0;
    m1 = mx1;
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float delta0 = quad_sum(pd0) / l0, delta1 = quad_sum(pd1) / l1;
  const float lse0 = fmaf(m0, scale_log2, log2f(l0)), lse1 = fmaf(m1, scale_log2, log2f(l1));
  {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int r0 = q0 + warp * 16 + lane / 4, tp = ntile * ROWS;
    float* st = stats + (long(n) * gridDim.y + h) * 2 * tp;
    if (lane % 4 == 0) {  // rows past T: p = ds = 0 in kernel 2
      st[r0] = r0 < T ? lse0 : INFINITY;
      st[tp + r0] = r0 < T ? delta0 : 0.0f;
      st[r0 + 8] = r0 + 8 < T ? lse1 : INFINITY;
      st[tp + r0 + 8] = r0 + 8 < T ? delta1 : 0.0f;
    }
  }

  // pass 2: p = exp2(s * scale_log2 - lse), ds = p (dp - delta) rounded to
  // bf16, dq += dS K
  float acc[DP / 2];
  zero(acc);
  for (int j = 0; j < ntile; ++j, ++item) {
    float s[32], dp[32];
    products(s, dp, item);
    tile_mask(s, j * ROWS, T);
    uint32_t ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float d[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool r1 = e & 2;
        const float p = exp2f(fmaf(s[8 * kk + e], scale_log2, -(r1 ? lse1 : lse0)));
        d[e] = p * (dp[8 * kk + e] - (r1 ? delta1 : delta0));
      }
      pack_a(ds[kk], d);
    }
    wgmma_fence();
    wgmma_rs_acc<DP>(acc, ds, slot(item));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    rg.release(item, load_item);
  }
  store_rows<DP>(acc, dq + long(n) * T * ldg + long(h) * D, q0, T, D, ldg, scale, scale);
}

// Kernel 2: dk and dv of 64 key rows of (sample blockIdx.z, head
// blockIdx.y), from kernel 1's statistics.
template <int DP>
__global__ void __launch_bounds__(WG_THREADS, DP == 64 ? 3 : 2)
attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const float* __restrict__ stats, int T, int D,
                     long ldg, float scale, float scale_log2) {
  using B = TileBytes<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ks = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t vs = ks + B::TILE, ring = vs + B::TILE;  // slot: Q tile, then dO tile
  const uint32_t sts = ring + BWD_STAGES * 2 * B::TILE;  // slot: 64 lse, then 64 delta
  const uint32_t bar_kv = sts + BWD_STAGES * BWD_STAT_BYTES;
  const int n = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int ntile = (T + ROWS - 1) / ROWS, tp = ntile * ROWS;
  const BwdRing rg{bar_kv + 8, ntile};  // items: the query tiles
  const float* st = stats + (long(n) * gridDim.y + h) * 2 * tp;
  const CUtensorMap *mq = &tq, *mdo = &tdo;
  auto slot = [&](int i) { return ring + (i % BWD_STAGES) * 2 * B::TILE; };
  auto stat_slot = [&](int i) { return sts + (i % BWD_STAGES) * BWD_STAT_BYTES; };
  auto load_item = [&](int i) {
    mbar_expect_tx(rg.full(i), 2 * B::TILE + BWD_STAT_BYTES);
    load_tile<DP>(slot(i), mq, rg.full(i), h, i * ROWS, n);
    load_tile<DP>(slot(i) + B::TILE, mdo, rg.full(i), h, i * ROWS, n);
    bulk_load(stat_slot(i), st + i * ROWS, BWD_STAT_BYTES / 2, rg.full(i));
    bulk_load(stat_slot(i) + BWD_STAT_BYTES / 2, st + tp + i * ROWS, BWD_STAT_BYTES / 2,
              rg.full(i));
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    rg.init();
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_kv, 2 * B::TILE);
    load_tile<DP>(ks, &tk, bar_kv, h, k0, n);
    load_tile<DP>(vs, &tv, bar_kv, h, k0, n);
    for (int i = 0; i < BWD_STAGES && i < rg.items; ++i) load_item(i);
  }
  mbar_wait(bar_kv, 0);

  float dv_acc[DP / 2], dk_acc[DP / 2];
  zero(dv_acc);
  zero(dk_acc);
  const int c0 = 2 * (threadIdx.x % 4);  // this thread's query columns: 8i + c0 + {0, 1}
  for (int i = 0; i < ntile; ++i) {
    float s[32], dp[32];
    rg.wait(i);
    wgmma_fence();
    wgmma_nt<DP>(s, ks, slot(i));             // S^T: keys x queries
    wgmma_nt<DP>(dp, vs, slot(i) + B::TILE);  // dP^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    const float* lse = reinterpret_cast<const float*>(smem_raw + (stat_slot(i) - smem_u32(smem_raw)));
    const float* delta = lse + ROWS;
    uint32_t pa[4][4], ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float p[8], d[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = 8 * (2 * kk + e / 4) + c0 + (e & 1);
        p[e] = exp2f(fmaf(s[8 * kk + e], scale_log2, -lse[col]));
        d[e] = p[e] * (dp[8 * kk + e] - delta[col]);
      }
      pack_a(pa[kk], p);
      pack_a(ds[kk], d);
    }
    wgmma_fence();
    wgmma_rs_acc<DP>(dv_acc, pa, slot(i) + B::TILE);  // dv += P^T dO
    wgmma_rs_acc<DP>(dk_acc, ds, slot(i));            // dk += dS^T Q
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    rg.release(i, load_item);
  }
  const long base = long(n) * T * ldg + long(h) * D;
  store_rows<DP>(dv_acc, dv + base, k0, T, D, ldg, 1.0f, 1.0f);
  store_rows<DP>(dk_acc, dk + base, k0, T, D, ldg, scale, scale);
}

}  // namespace sm90
}  // namespace lfm
