// bf16 softmax attention forward for Hopper (sm_90a), on wgmma and TMA: the
// bf16 K1, the attention inside K2 and K5's forward, and the bf16 K4.
//
// It replaces the bf16 instances of K1's and K4's WMMA kernels, and computes
// what the TPU kernels of lfm_tpu/kernels/flash_attention.py compute, at
// their rounding points:
//  - `_attn_small_kernel` (K1): the whole row of s = q k^T / sqrt(D) in f32,
//    p = exp(s - m) with the row's exact max m, p rounded to bf16 before
//    P V, f32 accumulation, o / l at the end;
//  - `_dit_block_kernel`'s and `_block_fwd_call`'s attention (K2, K5;
//    NORM_P): p / l rounded to bf16 before P V;
//  - `_flash_kernel` (K4): keys in blocks of BK (`_pick_block(T, 512)`); per
//    block m_new = max(m, the block's row max), p = exp(s - m_new) rounded
//    to bf16, alpha = exp(m - m_new) rescales l and acc in f32.
// The entry point is launch_attention_sm90 (bk = 0: the whole sequence, K1's
// semantics; bk > 0: K4's key blocks).
//
// Layout. q, k, v are read in place from (N, T, row) slabs: token t of
// sample n, head h at ptr[(n*T + t)*ld + h*D], so ld = H*D for separate
// tensors and 3C for the thirds of a fused qkv row. Each is described to
// TMA by a 4-D tensor map over (D, H, T, N) with strides (D, ld, T*ld)
// elements, boxes of CW columns x 64 rows. The head is its own dimension
// (not a column range of a 3-D (ld, T, N) map) so that the columns past D
// (56 and 72 pad to 64 and 80) and the rows past T are zero-filled by TMA,
// never read from the next head or sample. D = 56/64 use one 64-column box
// with the 128-byte swizzle; D = 72/80 five 16-column boxes with the 32-byte
// swizzle (a box may span at most the swizzle width). The wgmma shared-memory
// descriptors use the same swizzle: K-major for Q and K (S = Q K^T),
// MN-major with the transpose bit for V (O = P V).
//
// Whole-row mode (T <= 256 and one key block: every shipped DiT preset's K1,
// K2 and K5 call). One warpgroup per CTA takes 64 query rows of one
// (sample, head). One thread loads Q and K (one mbarrier) and V (another)
// by TMA. S for all T keys is computed once with wgmma m64n64k16 into
// registers (64 x 256 f32 is 128 registers a thread); max, exp and sum run
// on the accumulator layout, each row's 4 values per n8 block held by one
// quad (shuffles within the quad); p (or p / l) is rounded to bf16 and
// packed straight into wgmma's register-A fragments for P V (the
// accumulator layout of m64nN is the A layout of m64k16). No f32 stage goes
// through shared memory. K and V at T = 256 take 64 KB and Q 8 KB; at D <=
// 64 three CTAs share an SM (<= 168 registers, no spills), so one's loads
// overlap the others' math; at D = 72/80, two.
//
// Key-block mode (K4, and K1/K2/K5 at 256 < T <= 1024, which only a model
// override reaches). Two warpgroups per CTA (128 query rows) share a ring of
// STAGES slots, each a 64-key K tile and V tile, filled by TMA; one thread
// refills a slot when all 8 warps have released it (full and empty
// mbarriers per slot, phase parity = the slot's use count & 1). Per key
// block, sweep 1 runs Q K^T tile by tile for the block's row max (and, for
// NORM_P, its l, online); sweep 2 recomputes Q K^T and forms p against the
// block's m_new, then P V. That keeps the TPU kernel's rounding point (p
// rounded against the max of the whole block) at twice the QK^T operations:
// 1.5x the kernel's. Keys past the block end b1 (a block of 206, 275 or 400
// keys ends inside a tile) or past T are set to -inf before the max; query
// rows past T are computed but not stored.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s). K1 at (200, 256,
// 16, 64): 4*N*T*H*D*2 = 419 MB against 4*N*H*T^2*D = 53.7 GFLOP, 0.125 ms
// by bytes (0.054 by operations): the design reads each byte of q, k, v from
// device memory about once (the 4 CTAs of a (sample, head) read K and V
// through L2) and keeps S, p and the statistics in registers. K4 at (2,
// 4096, 16, 64): 137 GFLOP, 0.139 ms by operations; the recompute of sweep 1
// adds half, so this design reaches at most 67% of that bound. Both keep the
// tensor cores fed by wgmma from swizzled shared memory, with TMA loads
// overlapping the math of other CTAs (whole row) or of the next tiles
// (ring).
#pragma once

#include "sm90.cuh"

namespace lfm {
namespace sm90 {

constexpr int ROWS = 64;          // rows of a tile: a warpgroup's query rows, one key tile
constexpr int WG_THREADS = 128;   // one warpgroup
constexpr int WHOLE_MAX_T = 256;  // whole-row mode: S of 4 key tiles in registers
constexpr int WHOLE_TILES = WHOLE_MAX_T / ROWS;
constexpr int RING_WG = 2;        // key-block mode: warpgroups per CTA
constexpr int STAGES = 4;         // key-block mode: ring slots (a K and a V tile each)

// How a tile of 64 rows x DP (padded head dim) lies in shared memory: CHUNKS
// boxes of CW columns, each 64 rows x CW*2 bytes, swizzled by TMA as the
// wgmma descriptor's layout says.
template <int DP>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int CW = 64;
  static constexpr CUtensorMapSwizzle SWIZZLE = CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr uint64_t LAYOUT = 1;  // wgmma descriptor: 128-byte swizzle
  static constexpr uint32_t SBO = 1024;  // 8 rows of 128 bytes
};
template <>
struct Tile<80> {
  static constexpr int CW = 16;
  static constexpr CUtensorMapSwizzle SWIZZLE = CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr uint64_t LAYOUT = 3;  // wgmma descriptor: 32-byte swizzle
  static constexpr uint32_t SBO = 256;   // 8 rows of 32 bytes
};

template <int DP>
struct TileBytes {
  static constexpr int CHUNKS = DP / Tile<DP>::CW;
  static constexpr uint32_t CHUNK = ROWS * Tile<DP>::CW * 2;
  static constexpr uint32_t TILE = ROWS * DP * 2;  // a multiple of 1024: every tile is aligned
};

// one box of the (D, H, T, N) map at column c0, head h, row t0, sample n
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int h, int t0, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(h), "r"(t0), "r"(n)
      : "memory");
}

// rows [t0, t0 + 64) of head h of sample n into a tile (TileBytes::TILE bytes
// counted on `bar`)
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int h, int t0, int n) {
#pragma unroll
  for (int c = 0; c < TileBytes<DP>::CHUNKS; ++c)
    tma_load(dst + c * TileBytes<DP>::CHUNK, map, bar, c * Tile<DP>::CW, h, t0, n);
}

// the high word of the wgmma shared-memory descriptors (sm90.cuh) in a
// tile's swizzle
template <int DP>
__device__ __forceinline__ uint32_t desc_hi() {
  return desc_hi_bits(Tile<DP>::SBO, Tile<DP>::LAYOUT);
}
// K-major operand (Q, K) at k-step kk (columns 16kk .. 16kk+15) of a tile:
// inside a 128-byte swizzle row the start moves by 32 bytes; at the 32-byte
// swizzle each k-step is a chunk of its own
template <int DP>
__device__ __forceinline__ uint32_t kmajor_desc(uint32_t tile, int kk) {
  constexpr int CW = Tile<DP>::CW;
  return desc_lo_bits(tile + (kk * 16 / CW) * TileBytes<DP>::CHUNK + (kk * 16 % CW) * 2, 16);
}
// V as P V's MN-major B operand at k-step kk (keys 16kk .. 16kk+15) of
// consecutive tiles: 8-key groups SBO apart, CW-column chunks LBO apart
template <int DP>
__device__ __forceinline__ uint32_t v_desc(uint32_t tiles, int kk) {
  constexpr int CW = Tile<DP>::CW;
  return desc_lo_bits(tiles + (kk / 4) * TileBytes<DP>::TILE + (kk % 4) * 16 * CW * 2,
                     TileBytes<DP>::CHUNK);
}

// S (64 x 64, f32) (+)= A (64 x 16) . B (64 x 16)^T, both K-major in shared memory,
// given by the low words of their descriptors and the shared high word; acc = 0
// overwrites S
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint32_t a, uint32_t b, uint32_t hi,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %35, 0;\n"
      "mov.b64 da, {%32, %34};\n"
      "mov.b64 db, {%33, %34};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a), "r"(b), "r"(hi), "r"(acc));
}

template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<64> {
  // O (64 x 64, f32) (+)= A (64 x 16, registers) . B (16 x 64, shared memory, MN-major)
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint32_t b,
                                             uint32_t hi, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 db;\n"
        "setp.ne.b32 p, %38, 0;\n"
        "mov.b64 db, {%36, %37};\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(hi), "r"(acc));
  }
};

template <>
struct WgmmaRS<80> {
  // O (64 x 80, f32) (+)= A (64 x 16, registers) . B (16 x 80, shared memory, MN-major)
  static __device__ __forceinline__ void run(float (&d)[40], const uint32_t (&a)[4], uint32_t b,
                                             uint32_t hi, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 db;\n"
        "setp.ne.b32 p, %46, 0;\n"
        "mov.b64 db, {%44, %45};\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31, "
          "%32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, db, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(hi), "r"(acc));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator layout of wgmma m64nN (f32): thread `lane` of warp w of the
// warpgroup holds, for each n8 block i, d[4i + e] at row 16w + lane/4 (e =
// 0, 1) or that row + 8 (e = 2, 3), column 8i + 2*(lane % 4) + (e & 1). The
// bf16 A fragment of k-step kk (columns 16kk .. 16kk+15) is n8 blocks 2kk
// and 2kk+1 packed in pairs.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float* d) {
  a[0] = pack_bf16(d[0], d[1]);
  a[1] = pack_bf16(d[2], d[3]);
  a[2] = pack_bf16(d[4], d[5]);
  a[3] = pack_bf16(d[6], d[7]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// keys >= limit of one 64-key tile of S set to -inf (a no-op unless the tile
// crosses limit: the branch is uniform)
__device__ __forceinline__ void tile_mask(float (&s)[32], int key0, int limit) {
  if (key0 + ROWS <= limit) return;
  const int c0 = key0 + 2 * (threadIdx.x % 4);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + 8 * i + (e & 1) >= limit) s[4 * i + e] = -INFINITY;
}

// the tile masked, then folded into the maxima of this thread's two rows
// (raw scores: the scale is positive, so the max commutes with it)
__device__ __forceinline__ void tile_max(float (&s)[32], int key0, int limit, float& m0,
                                         float& m1) {
  tile_mask(s, key0, limit);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m0 = fmaxf(m0, fmaxf(s[4 * i], s[4 * i + 1]));
    m1 = fmaxf(m1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
}

// p = exp(scale * (s - m)) = exp2(s * scale_log2 - ms) in place, with ms =
// m * scale_log2 (finite); -inf gives 0. Adds to this thread's part of l.
__device__ __forceinline__ void tile_exp(float (&s)[32], float ms0, float ms1, float scale_log2,
                                         float& l0, float& l1) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[4 * i + e], scale_log2, -(e < 2 ? ms0 : ms1)));
      s[4 * i + e] = p;
      if (e < 2) l0 += p; else l1 += p;
    }
}

// rows [q0, q0 + 64) of the warpgroup's O (64 x DP f32) times inv0 / inv1,
// rounded to bf16; rows >= T and columns >= D are not stored
template <int DP>
__device__ __forceinline__ void store_rows(const float (&o)[DP / 2], bf16* __restrict__ out,
                                           int q0, int T, int D, long ldo, float inv0,
                                           float inv1) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % WG_THREADS) / 32;
  const int r0 = q0 + warp * 16 + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + c0;
    if (col >= D) continue;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(out + long(r0) * ldo + col) =
          pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    if (r0 + 8 < T)
      *reinterpret_cast<uint32_t*>(out + long(r0 + 8) * ldo + col) =
          pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
}

// Whole-row mode: one warpgroup, 64 query rows of (sample blockIdx.z, head
// blockIdx.y), all T <= 256 keys at once.
// DP 64: three CTAs an SM (73 KB of shared memory and <= 168 registers each)
template <int DP, bool NORM_P>
__global__ void __launch_bounds__(WG_THREADS, DP == 64 ? 3 : 2)
attn_whole_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int T, int D,
                  long ldo, float scale_log2) {
  using B = TileBytes<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms need 1024 B
  const uint32_t ks = qs + B::TILE, vs = ks + WHOLE_TILES * B::TILE;
  const uint32_t bar_qk = vs + WHOLE_TILES * B::TILE, bar_v = bar_qk + 8;
  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int nkt = (T + ROWS - 1) / ROWS;

  if (threadIdx.x == 0) {
    mbar_init(bar_qk, 1);
    mbar_init(bar_v, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_qk, (1 + nkt) * B::TILE);
    load_tile<DP>(qs, &tq, bar_qk, h, q0, n);
    for (int j = 0; j < nkt; ++j) load_tile<DP>(ks + j * B::TILE, &tk, bar_qk, h, j * ROWS, n);
    mbar_expect_tx(bar_v, nkt * B::TILE);
    for (int j = 0; j < nkt; ++j) load_tile<DP>(vs + j * B::TILE, &tv, bar_v, h, j * ROWS, n);
  }

  // S = Q K^T for every key tile, once. Tiles past T are never written:
  // tile_max sets them to -inf whole. (Zeroing them first would hold 128
  // registers across the loads and spill at three CTAs an SM.)
  float s[WHOLE_TILES][32];
  mbar_wait(bar_qk, 0);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < WHOLE_TILES; ++j)
    if (j < nkt) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(s[j], kmajor_desc<DP>(qs, kk), kmajor_desc<DP>(ks + j * B::TILE, kk),
                     desc_hi<DP>(), kk);
    }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int j = 0; j < WHOLE_TILES; ++j) fence_regs(s[j]);

  // the exact row max, p = exp(s - m), l = sum p, all in f32 registers
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int j = 0; j < WHOLE_TILES; ++j) tile_max(s[j], j * ROWS, T, m0, m1);
  const float ms0 = quad_max(m0) * scale_log2, ms1 = quad_max(m1) * scale_log2;
#pragma unroll
  for (int j = 0; j < WHOLE_TILES; ++j) tile_exp(s[j], ms0, ms1, scale_log2, l0, l1);
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;

  // p (NORM_P: p / l) rounded to bf16, packed as register-A fragments
  uint32_t pa[WHOLE_TILES * 4][4];
#pragma unroll
  for (int j = 0; j < WHOLE_TILES; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float* d = &s[j][8 * kk];
      if (NORM_P) {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] *= (e & 2) ? inv1 : inv0;
      }
      pack_a(pa[4 * j + kk], d);
    }

  // O = P V (the first k-step overwrites acc)
  float acc[DP / 2];
  mbar_wait(bar_v, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WHOLE_TILES * 4; ++kk)
    if (kk < 4 * nkt) WgmmaRS<DP>::run(acc, pa[kk], v_desc<DP>(vs, kk), desc_hi<DP>(), kk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);

  store_rows<DP>(acc, o + long(n) * T * ldo + long(h) * D, q0, T, D, ldo,
                 NORM_P ? 1.0f : inv0, NORM_P ? 1.0f : inv1);
}

// Key-block mode: RING_WG warpgroups, 64 query rows each, keys in blocks of
// BK (T % BK == 0, or BK = T), 64-key tiles through a ring of STAGES slots.
template <int DP, bool NORM_P>
__global__ void __launch_bounds__(RING_WG * WG_THREADS, 2)
attn_blocked_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int T, int D,
                    int BK, long ldo, float scale_log2) {
  using B = TileBytes<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = qs + RING_WG * B::TILE;  // slot s: K tile, then V tile
  const uint32_t bars = ring + STAGES * 2 * B::TILE;
  const uint32_t bar_q = bars;  // then full[STAGES], empty[STAGES]
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  const CUtensorMap *mq = &tq, *mk = &tk, *mv = &tv;
  const int n = blockIdx.z, h = blockIdx.y;
  const int wg = threadIdx.x / WG_THREADS, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * RING_WG * ROWS + wg * ROWS;
  const int ntile = (BK + ROWS - 1) / ROWS, nblk = (T + BK - 1) / BK;
  const int items = nblk * 2 * ntile;  // per block: ntile K tiles, then ntile K + V tiles

  // item i of the load sequence into its slot (one thread)
  auto load_item = [&](int i) {
    const int s = i % STAGES, r = i % (2 * ntile);
    const bool with_v = r >= ntile;
    const int k0 = (i / (2 * ntile)) * BK + (with_v ? r - ntile : r) * ROWS;
    const uint32_t slot = ring + s * 2 * B::TILE;
    mbar_expect_tx(full(s), (with_v ? 2 : 1) * B::TILE);
    load_tile<DP>(slot, mk, full(s), h, k0, n);
    if (with_v) load_tile<DP>(slot + B::TILE, mv, full(s), h, k0, n);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), RING_WG * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, RING_WG * B::TILE);
    for (int w = 0; w < RING_WG; ++w)
      load_tile<DP>(qs + w * B::TILE, mq, bar_q, h, blockIdx.x * RING_WG * ROWS + w * ROWS, n);
    for (int i = 0; i < STAGES && i < items; ++i) load_item(i);
  }

  // this warp is done with item i's slot; thread 0 refills it with item
  // i + STAGES once all warps are
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(i % STAGES));
    if (threadIdx.x == 0 && i + STAGES < items) {
      mbar_wait(empty(i % STAGES), (i / STAGES) & 1);
      load_item(i + STAGES);
    }
    __syncwarp();
  };
  // S = Q K^T for item i's K tile
  const uint32_t qw = qs + wg * B::TILE;
  auto qk = [&](float (&s)[32], int i) {
    mbar_wait(full(i % STAGES), (i / STAGES) & 1);
    const uint32_t kt = ring + (i % STAGES) * 2 * B::TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc<DP>(qw, kk), kmajor_desc<DP>(kt, kk), desc_hi<DP>(), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
  };

  float acc[DP / 2];  // zero: the first block scales it by alpha = 0
#pragma unroll
  for (int c = 0; c < DP / 2; ++c) acc[c] = 0.0f;
  float m_run0 = -INFINITY, m_run1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;  // l: this thread's part
  mbar_wait(bar_q, 0);
  int item = 0;
  for (int b = 0; b < nblk; ++b) {
    const int b0 = b * BK, b1 = min(b0 + BK, T);

    // sweep 1: the block's row max (NORM_P: and its sum, online per thread)
    float mt0 = -INFINITY, mt1 = -INFINITY, lb0 = 0.0f, lb1 = 0.0f;
    for (int t = 0; t < ntile; ++t, ++item) {
      float s[32];
      qk(s, item);
      release(item);
      float mx0 = mt0, mx1 = mt1;
      tile_max(s, b0 + t * ROWS, b1, mx0, mx1);
      if (NORM_P) {  // a thread that has seen no key yet takes 0 as its reference
        const float r0 = mx0 == -INFINITY ? 0.0f : mx0 * scale_log2;
        const float r1 = mx1 == -INFINITY ? 0.0f : mx1 * scale_log2;
        lb0 *= exp2f(mt0 * scale_log2 - r0);
        lb1 *= exp2f(mt1 * scale_log2 - r1);
        tile_exp(s, r0, r1, scale_log2, lb0, lb1);
      }
      mt0 = mx0;
      mt1 = mx1;
    }
    const float mq0 = quad_max(mt0), mq1 = quad_max(mt1);
    float inv0 = 1.0f, inv1 = 1.0f;
    if (NORM_P) {  // one block: the sequence's l, from each thread's part at its own max
      inv0 = 1.0f / quad_sum(mt0 == -INFINITY ? 0.0f : lb0 * exp2f((mt0 - mq0) * scale_log2));
      inv1 = 1.0f / quad_sum(mt1 == -INFINITY ? 0.0f : lb1 * exp2f((mt1 - mq1) * scale_log2));
    }
    const float m_new0 = fmaxf(m_run0, mq0), m_new1 = fmaxf(m_run1, mq1);
    const float alpha0 = exp2f((m_run0 - m_new0) * scale_log2);  // 0 at the first block
    const float alpha1 = exp2f((m_run1 - m_new1) * scale_log2);
    const float ms0 = m_new0 * scale_log2, ms1 = m_new1 * scale_log2;
    m_run0 = m_new0;
    m_run1 = m_new1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int c = 0; c < DP / 2; ++c) acc[c] *= (c & 2) ? alpha1 : alpha0;

    // sweep 2: p = exp(s - m_new) (NORM_P: p / l) rounded to bf16, acc += P V.
    // Issuing tile t + 1's Q K^T before tile t's softmax, so that the two
    // overlap within the warpgroup, ran slower on the H100 at K4's shapes:
    // with four warpgroups an SM the others already keep the tensor cores
    // busy during one's softmax.
    for (int t = 0; t < ntile; ++t, ++item) {
      float s[32];
      qk(s, item);
      tile_mask(s, b0 + t * ROWS, b1);
      tile_exp(s, ms0, ms1, scale_log2, l0, l1);
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float* d = &s[8 * kk];
        if (NORM_P) {
#pragma unroll
          for (int e = 0; e < 8; ++e) d[e] *= (e & 2) ? inv1 : inv0;
        }
        pack_a(pa[kk], d);
      }
      const uint32_t vt = ring + (item % STAGES) * 2 * B::TILE + B::TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaRS<DP>::run(acc, pa[kk], v_desc<DP>(vt, kk), desc_hi<DP>(), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      release(item);
    }
  }
  float inv0 = 1.0f, inv1 = 1.0f;
  if (!NORM_P) {
    inv0 = 1.0f / quad_sum(l0);
    inv1 = 1.0f / quad_sum(l1);
  }
  store_rows<DP>(acc, o + long(n) * T * ldo + long(h) * D, q0, T, D, ldo, inv0, inv1);
}

}  // namespace sm90

// The 4-D (D, H, T, N) tensor map of an (N, T, row) slab with row stride ld
// (elements): boxes of 64 rows by the padded head dim's chunk width (D <=
// 64: one 64-column box, 128-byte swizzle; else 16-column boxes, 32-byte
// swizzle), zero fill past D and T. Defined in attention_sm90.cu.
cudaError_t make_slab_map(CUtensorMap* map, const bf16* ptr, int N, int T, int H, int D,
                          long ld);

// bf16 attention on (N, T, row) slabs with row strides ldq/ldk/ldv/ldo
// (elements, 16-byte multiples; 16-byte aligned bases), D in 8..80 a
// multiple of 8. bk = 0: the whole sequence (K1; NORM_P rounds p / l, K2
// and K5), T <= 1024. bk > 0: K4's key blocks of bk (T % bk == 0), NORM_P
// false. Launches on `stream`, allocates nothing, returns the first error.
cudaError_t launch_attention_sm90(const bf16* q, const bf16* k, const bf16* v, bf16* o, int N,
                                  int T, int H, int D, long ldq, long ldk, long ldv, long ldo,
                                  int bk, bool norm_p, cudaStream_t stream);

}  // namespace lfm
