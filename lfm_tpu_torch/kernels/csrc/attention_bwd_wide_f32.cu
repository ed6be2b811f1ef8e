// f32 K3 at the origin ADM's wide heads, D = 128 (celeb256_adm, church_adm)
// and 256 (celeb512_adm): the port of lfm_tpu/kernels/flash_attention.py::
// attention_small_bwd (`_attn_small_bwd_kernel`) in f32 over the whole
// small-T gate (T <= 1024). The origin ADM's attention is an f32 island, so
// its training step runs this once per attention layer: celeb256_adm at (N,
// 16, 4, 128), celeb512_adm at (N, 64, 4, 128) and (N, 16, 4, 256), and an
// --attn_resolutions override up to T = 1024. Compiled apart from K3's
// other sources so that they build in parallel.
//
// Per (sample, head), with s = scale q k^T (scale = 1/sqrt(D)):
//   m = max_k s, e = exp(s - m), l = sum_k e, p = e / l,
//   dv = p^T do, dp = do v^T, delta = rowsum(dp * p), ds = p (dp - delta),
//   dq = scale ds k, dk = scale ds^T q
// all in f32 (f32 FMA products, no TF32, no tensor core, the exact row max):
// only the order of the f32 sums differs from the TPU kernel's. No atomics:
// every sum has a fixed order.
//
// What bounds it: 7 T H D * 4 bytes against 10 T^2 H D flops. At the
// presets' T = 16 and 64 the bytes do, or nearly: at (112, 16, 4, 128) 25.7
// MB, 7.7 us at 3.35 TB/s, against 0.15 GFLOP; past T ~ 200 the f32 units
// do. On the CUDA cores a product is held back by its shared-memory loads
// as much as by its FMAs (a 16-byte shared load costs the SM ~2.7 cycles,
// tools/smem_probe.py, against 4 warp FMAs a cycle), so every product here
// is register-blocked: a thread's tile reads each operand once per float4
// step for RM x RN FMA chains. Two routes, by shape (f32_k3_route mirrors
// them):
//
// 1. T <= 64 at D = 128, T <= 48 at D = 256 (every preset shape):
//    attn_wide_bwd_short_kernel<DP, TK>, one CTA a (sample, head), one
//    launch, no recompute and no trip through the statistics scratch. q,
//    k, v and do (TK = T rounded up to 16, 32, 64 or 48 rows; zero past T)
//    arrive by 16-byte cp.async, all in flight together. Threads 0-127 form
//    s = q k^T and threads 128-255 dp = do v^T at once, each over the TK
//    real-or-padded keys only; the row passes take the exact max, e, l, p,
//    delta and ds = p (dp - delta) on chip; then dq = scale ds k (rows of a
//    thread strided, 4 columns) and dk = scale ds^T q, dv = p^T do (RK
//    consecutive keys x 4 columns, both in one loop over the queries):
//    10 T^2 D flops. Shared memory: q, k, v, do (TK x (DP + 4 S)) and the
//    rows of s and dp: 40,960 bytes at (16, 128), so 4 CTAs an SM (448
//    CTAs at (112, 16, 4, 128): one wave); 174,080 at (64, 128); 75,776 at
//    (16, 256); 228,864 at (48, 256), the largest that fits (at D = 256
//    past T = 48 q, k, v and do alone pass 232,448 bytes).
// 2. Past those T: the FlashAttention-2 split, no atomics.
//    attn_wide_bwd_dq_kernel<DP, BQ, TK>: BQ query rows of one (sample,
//    head) a CTA, k and v through a ring of two cp.async slots (k for s, v
//    for dp, k again for dq; stages stop at T). For s and dp a slot holds
//    KS keys x a DC-column chunk of D, a key block's chunks in turn (the
//    accumulators carried across them), so that a stage is wide enough for
//    8 x 4 score tiles (4 x 8 at <128, 16, 1024>) beside the whole row of s,
//    which stays in shared memory (the exact max before any exp); dp stays
//    in registers (each lane its own tile rows); then m, l, delta to
//    flash_attention.bwd_stats_scratch and ds in place of p; dq = scale ds
//    k over KSQ-key stages of the whole row, in 8 x 4 tiles, split over
//    SPLIT groups of threads by key where 16 rows leave too few tiles.
//    Rows sized to T: <128, 64, 256> to T = 256 (KS 64, DC 128; 209,920
//    bytes), <128, 32, 512> to 512 (128, 64; 179,200), <128, 16, 1024>
//    past it (256, 32, SPLIT 4; 167,936), <256, 32, 256> (64, 128;
//    179,200) and <256, 16, 1024> (128, 64, SPLIT 2; 185,344); 8 x 8
//    score tiles beside the dp registers spilled.
//    attn_wide_bwd_dkdv_kernel<DP>: BK keys a CTA (64 at D = 128, 32 at
//    256; k and v held), the queries streamed in chunks of 32 (q, do, m, l,
//    delta) through a ring of two stages; threads 0-127 recompute s^T and
//    p, threads 128-255 dp^T (8 x 4 tiles, the dq kernel's sums, so p and
//    ds are its bits); then the first half runs dv += p^T do while the
//    second forms ds and, behind a barrier of its own, dk += ds^T q (8 x 8
//    tiles). 158,464 / 218,880 bytes.
//
// Score tiles (both routes): a thread sums RM rows x RN keys of a product
// over one of S slices of D (S = 2 at D = 128, 4 at 256: float4 blocks b =
// sl, sl + S, ... of the row), and the S lanes of a tile add their partials
// as (p0 + p2) + (p1 + p3) (p0 + p1 at S = 2), each lane keeping RM / S of
// the tile's rows (reduce_scatter). So a tile of 8 x 4 or more fits the
// shared memory that holds the operands at these widths, where one thread a
// whole dot product would leave 1 x 2 (the older kernel's dq scores: 3
// loads for 8 FMA). A quarter-warp shares the row group and holds 8 / S key
// groups x S slices: its A loads read S addresses, its B loads 8 / S rows,
// and rows padded by 4 S floats put those on distinct banks.
//
// The f32 sums: s and dp over D, S chains in order (one a slice) added as
// above, the same in both routes' kernels (so route 2's recomputed p, dp
// and ds are the dq kernel's bits); l and (route 1) delta: each of the G
// threads of a row its keys (sub + G x) in order, then a butterfly (xor 1,
// 2, ...); route 2's delta: each lane its keys in order, the key groups'
// partials added in order; dq one chain over the keys (route 2 with 16
// query rows: one a group of keys, the groups' totals added in order), dk
// and dv one chain over the queries. m is the max of the unscaled s,
// scaled once, and scale s - m one FMA, as in attention_row_f32.cuh.
#include "attention.cuh"
#include "attention_long_f32.cuh"

namespace lfm {
namespace wide32 {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// Phase profile: tools/k3_wide_phases.py compiles this file with
// -DLFM_K3_PHASES. Thread 0 of the CTA at the middle of the grid then
// stamps clock64() at each phase boundary (K3_PHASE) and sums the cycles it
// spends waiting for loads (K3_WAIT_*, slot 15) into k3_phase_clock[kernel
// 0 one-pass, 1 dq, 2 dk/dv][slot]. Without the macro nothing is compiled.
#ifdef LFM_K3_PHASES
__device__ long long k3_phase_clock[3][16];
__device__ __forceinline__ bool k3_probe() {
  return threadIdx.x == 0 && blockIdx.x == gridDim.x / 2 && blockIdx.y == gridDim.y / 2 &&
         blockIdx.z == gridDim.z / 2;
}
#define K3_PHASE(kern, i) \
  if (k3_probe()) k3_phase_clock[kern][i] = clock64()
#define K3_WAIT_BEGIN const long long k3_t0 = clock64()
#define K3_WAIT_END(kern) \
  if (k3_probe()) k3_phase_clock[kern][15] += clock64() - k3_t0
#else
#define K3_PHASE(kern, i)
#define K3_WAIT_BEGIN
#define K3_WAIT_END(kern)
#endif

// slices of D a score tile is summed over, and the row stride (floats) of
// q, k, v and do in shared memory
template <int DP>
struct Split {
  static constexpr int S = DP <= 128 ? 2 : 4;
  static constexpr int LD = DP + 4 * S;
};

// threads on a row in the row passes take keys sub + G x; a row of scores
// is padded so that the 32 / G rows a warp reads fall on distinct banks
__host__ __device__ constexpr int score_ld(int tk, int g) {
  return tk + g * ((tk / g) % 2 ? 2 : 1);
}

// rows [row0, row0 + ROWS) of an (N, T, row) slab into a tile of row stride
// LD; rows >= T zero-filled. Thread t copies the 16-byte chunks t, t +
// THREADS, ...
template <int DP, int LD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* base, long ld, int row0,
                                          int T) {
  constexpr int C4 = DP / 4, N = ROWS * C4;
  const float* src = base + long(row0) * ld;
  const int rows = T - row0;
#pragma unroll
  for (int k = 0; k < (N + THREADS - 1) / THREADS; ++k) {
    const int id = int(threadIdx.x) + k * THREADS;
    if (N % THREADS == 0 || id < N) {
      const int r = id / C4, c = (id % C4) * 4;
      const bool ok = r < rows;
      cp_async16(dst + r * LD + c, ok ? src + long(r) * ld + c : base, ok);
    }
  }
}

// The score tile of thread t of NT: rows rg + RGN i, keys kg + KGN j, D
// slice sl. A quarter-warp shares rg and holds 8 / S key groups x S slices.
template <int S, int RGN, int NT>
struct Tile {
  static constexpr int KQ = 8 / S;  // key groups of a quarter-warp
  static constexpr int KGN = (NT / 8 / RGN) * KQ;
  static_assert(NT / 8 % RGN == 0, "row groups divide the quarter-warps");
  static __device__ __forceinline__ void at(int t, int& rg, int& kg, int& sl) {
    const int quarter = t / 8;
    sl = t % S;
    rg = quarter % RGN;
    kg = (quarter / RGN) * KQ + (t / S) % KQ;
  }
};

// acc[i][j] += sum over the float4 blocks d = 4 sl, 4 (sl + S), ... of
// columns [0, COLS) of A[rg + RGN i][d..d+3] . B[kg + KGN j][d..d+3], in
// order, one FMA a term (A and B of row strides LDA, LDB). Over the column
// chunks of a row in turn (COLS / 4 a multiple of S), a slice's chain runs
// over the row's blocks sl, sl + S, ... in order, as over the whole row.
// CM: a step loads its RM + RN float4 first and issues the FMAs by
// component (x for every element, then y, z, w), fully unrolled; else
// element by element, unrolled twice. The same sums either way: CM
// measured 3-10% faster alone (tools/fma_tile_probe.py) and in the
// one-pass and dk/dv kernels, 1.4-1.7x slower in the dq kernel's score
// phases at T <= 256, where the dp registers are live
// (tools/k3_wide_phases.py).
template <int COLS, int LDA, int LDB, int S, int RM, int RN, int RGN, int KGN, bool CM = true>
__device__ __forceinline__ void nt_split(float (&acc)[RM][RN], const float* A, int rg,
                                         const float* B, int kg, int sl) {
  static_assert(COLS % (4 * S) == 0, "whole blocks of every slice");
  A += rg * LDA + 4 * sl;
  B += kg * LDB + 4 * sl;
  if constexpr (!CM) {
#pragma unroll 2
    for (int d = 0; d < COLS; d += 4 * S) {
      float4 a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = *reinterpret_cast<const float4*>(A + RGN * i * LDA + d);
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float4 w = *reinterpret_cast<const float4*>(B + KGN * j * LDB + d);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          acc[i][j] = fmaf(a[i].x, w.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, w.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, w.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, w.w, acc[i][j]);
        }
      }
    }
  } else {
#pragma unroll
    for (int b = 0; b < COLS / (4 * S); ++b) {
      float4 a[RM], w[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        a[i] = *reinterpret_cast<const float4*>(A + RGN * i * LDA + 4 * S * b);
#pragma unroll
      for (int j = 0; j < RN; ++j)
        w[j] = *reinterpret_cast<const float4*>(B + KGN * j * LDB + 4 * S * b);
#pragma unroll
      for (int j = 0; j < RN; ++j)
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(a[i].x, w[j].x, acc[i][j]);
#pragma unroll
      for (int j = 0; j < RN; ++j)
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(a[i].y, w[j].y, acc[i][j]);
#pragma unroll
      for (int j = 0; j < RN; ++j)
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(a[i].z, w[j].z, acc[i][j]);
#pragma unroll
      for (int j = 0; j < RN; ++j)
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(a[i].w, w[j].w, acc[i][j]);
    }
  }
}

// Add the S slices' partials of a tile (lanes sl = t % S, adjacent) and
// keep rows [sl RM / S, (sl + 1) RM / S) of it in acc[0 .. RM / S): the
// partials add as (p0 + p2) + (p1 + p3) at S = 4, p0 + p1 at S = 2, the
// same bits in every lane that holds the element
template <int S, int RM, int RN>
__device__ __forceinline__ void reduce_scatter(float (&acc)[RM][RN], int sl) {
  static_assert(RM % S == 0, "a lane keeps whole tile rows");
  if constexpr (S == 4) {
    constexpr int H = RM / 2;
    const bool hi = sl & 2;
#pragma unroll
    for (int i = 0; i < H; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float mine = hi ? acc[i + H][j] : acc[i][j];
        const float give = hi ? acc[i][j] : acc[i + H][j];
        acc[i][j] = mine + __shfl_xor_sync(FULL, give, 2);
      }
  }
  constexpr int H = RM / S;
  const bool lo = sl & 1;
#pragma unroll
  for (int i = 0; i < H; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const float mine = lo ? acc[i + H][j] : acc[i][j];
      const float give = lo ? acc[i][j] : acc[i + H][j];
      acc[i][j] = mine + __shfl_xor_sync(FULL, give, 1);
    }
}

// across the G adjacent lanes of a row: xor 1, 2, ..., each lane adding its
// partner's value to its own (the same bits in all G)
template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// acc[i][0..3] += sum_k A[r0 + RS i][k] B[k][c..c+3], k in order over
// [0, klen), klen % 4 == 0; A's row stride lda is a run-time value
template <int RM, int RS, int LDB>
__device__ __forceinline__ void nn_rows(float (&acc)[RM][4], const float* A, int lda, int r0,
                                        const float* B, int c, int klen) {
#pragma unroll 2
  for (int k = 0; k < klen; k += 4) {
    float4 a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (r0 + RS * i) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(B + (k + kk) * LDB + c);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
        acc[i][0] = fmaf(av, b.x, acc[i][0]);
        acc[i][1] = fmaf(av, b.y, acc[i][1]);
        acc[i][2] = fmaf(av, b.z, acc[i][2]);
        acc[i][3] = fmaf(av, b.w, acc[i][3]);
      }
    }
  }
}

// RK consecutive floats from p (16-byte aligned where RK % 4 == 0, else 8)
template <int RK>
__device__ __forceinline__ void load_run(float (&x)[RK], const float* p) {
  if constexpr (RK % 4 == 0) {
#pragma unroll
    for (int i = 0; i < RK; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      x[i] = v.x, x[i + 1] = v.y, x[i + 2] = v.z, x[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < RK; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      x[i] = v.x, x[i + 1] = v.y;
    }
  }
}

// ---------------------------------------------------------------- route 1

// q, k, v, do (TK rows each), the rows of s (then p) and of dp (then ds)
template <int DP, int TK>
struct Short {
  static constexpr int S = Split<DP>::S, LD = Split<DP>::LD;
  static constexpr int TKP = TK <= 16 ? 16 : TK <= 32 ? 32 : 64;  // rows of the row passes
  static constexpr int G = THREADS / TKP;
  static constexpr int LDS = score_ld(TK, G);
  // score tiles: RM x RN on 128 threads a product
  static constexpr int RM = TK == 16 ? S : TK == 32 ? 4 : DP == 128 ? 8 : 12;
  static constexpr int RGN = TK / RM;
  using TL = Tile<S, RGN, THREADS / 2>;
  static constexpr int KGN = TL::KGN, RN = TK / KGN;
  static_assert(RGN * RM == TK && KGN * RN == TK, "score tiles cover TK x TK");
  // products: dq rows grp + RS i, dk / dv keys RK grp .. + RK; 4 columns
  static constexpr int CG = DP / 4, RS = THREADS / CG, RK = TK / RS;
  static constexpr int K = TK * LD, V = 2 * K, DO = 3 * K, SS = 4 * K, DPS = SS + TK * LDS;
  static constexpr size_t BYTES = 4 * size_t(DPS + TK * LDS);
  static constexpr int MIN_BLOCKS = TK == 16 ? (DP == 128 ? 4 : 3) : TK == 32 && DP == 128 ? 2 : 1;
};

template <int DP, int TK>
__global__ void __launch_bounds__(THREADS, Short<DP, TK>::MIN_BLOCKS)
attn_wide_bwd_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           float* __restrict__ dq, float* __restrict__ dk,
                           float* __restrict__ dv, int T, long ldq, long ldk, long ldv,
                           long lddo, long ldg, float scale) {
  using L = Short<DP, TK>;
  constexpr int LD = L::LD, LDS = L::LDS, G = L::G;
  extern __shared__ __align__(16) float sm[];
  float *qs = sm, *ks = sm + L::K, *vs = sm + L::V, *dos = sm + L::DO;
  float *ss = sm + L::SS, *dps = sm + L::DPS;
  const int n = blockIdx.y, h = blockIdx.x;
  const long hd = long(h) * DP;
  K3_PHASE(0, 0);

  load_rows<DP, LD, TK>(qs, q + long(n) * T * ldq + hd, ldq, 0, T);
  load_rows<DP, LD, TK>(ks, k + long(n) * T * ldk + hd, ldk, 0, T);
  load_rows<DP, LD, TK>(vs, v + long(n) * T * ldv + hd, ldv, 0, T);
  load_rows<DP, LD, TK>(dos, dout + long(n) * T * lddo + hd, lddo, 0, T);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  K3_PHASE(0, 1);

  // s = q k^T on threads 0-127, dp = do v^T on 128-255 (warp-uniform);
  // keys past T: s = -inf
  {
    const bool is_dp = threadIdx.x >= THREADS / 2;
    int rg, kg, sl;
    L::TL::at(threadIdx.x % (THREADS / 2), rg, kg, sl);
    float acc[L::RM][L::RN];
#pragma unroll
    for (int i = 0; i < L::RM; ++i)
#pragma unroll
      for (int j = 0; j < L::RN; ++j) acc[i][j] = 0.0f;
    nt_split<DP, LD, LD, L::S, L::RM, L::RN, L::RGN, L::KGN>(acc, is_dp ? dos : qs, rg,
                                                          is_dp ? vs : ks, kg, sl);
    reduce_scatter<L::S>(acc, sl);
    float* dst = is_dp ? dps : ss;
    constexpr int OWN = L::RM / L::S;
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      const int row = rg + L::RGN * (sl * OWN + i);
#pragma unroll
      for (int j = 0; j < L::RN; ++j) {
        const int key = kg + L::KGN * j;
        dst[row * LDS + key] = is_dp || key < T ? acc[i][j] : -INFINITY;
      }
    }
  }
  __syncthreads();
  K3_PHASE(0, 2);

  // the row passes: G threads a row, keys sub + G x; m, e, l, p, delta,
  // ds = p (dp - delta); p over s, ds over dp
  {
    const int r = threadIdx.x / G, sub = threadIdx.x % G;
    if (r < TK) {  // whole warps
      constexpr int X = TK / G;
      float* srow = ss + r * LDS + sub;
      float* drow = dps + r * LDS + sub;
      float e[X], d[X];
      float mx = -INFINITY;
#pragma unroll
      for (int x = 0; x < X; ++x) {
        e[x] = srow[G * x];
        d[x] = drow[G * x];
        mx = fmaxf(mx, e[x]);
      }
      const float m = __fmul_rn(scale, group_max<G>(mx));
      float l = 0.0f;
#pragma unroll
      for (int x = 0; x < X; ++x) {
        e[x] = expf(fmaf(scale, e[x], -m));
        l += e[x];
      }
      l = group_sum<G>(l);
      float delta = 0.0f;
#pragma unroll
      for (int x = 0; x < X; ++x) {
        e[x] = e[x] / l;  // p
        delta = fmaf(e[x], d[x], delta);
      }
      delta = group_sum<G>(delta);
#pragma unroll
      for (int x = 0; x < X; ++x) {
        srow[G * x] = e[x];
        drow[G * x] = e[x] * (d[x] - delta);
      }
    }
  }
  __syncthreads();
  K3_PHASE(0, 3);

  const int cg = threadIdx.x % L::CG, grp = threadIdx.x / L::CG;
  const long row_base = long(n) * T * ldg + hd;
  // dq = scale ds k: rows grp + RS i, one chain over the keys
  {
    float acc[L::RK][4];
#pragma unroll
    for (int i = 0; i < L::RK; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
    nn_rows<L::RK, L::RS, LD>(acc, dps, LDS, grp, ks, 4 * cg, (T + 3) & ~3);
    float mul[L::RK];
#pragma unroll
    for (int i = 0; i < L::RK; ++i) mul[i] = scale;
    row32::store_tile<L::RS>(acc, mul, dq + row_base, ldg, 0, grp, 4 * cg, T, DP);
  }
  K3_PHASE(0, 4);
  // dk = scale ds^T q, dv = p^T do: keys RK grp .. RK grp + RK - 1, one
  // chain over the queries
  {
    constexpr int RK = L::RK;
    float adk[RK][4], adv[RK][4];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) adk[i][c] = adv[i][c] = 0.0f;
    const int k0 = RK * grp;
#pragma unroll 2
    for (int j = 0; j < T; ++j) {
      float p[RK], ds[RK];
      load_run<RK>(p, ss + j * LDS + k0);
      load_run<RK>(ds, dps + j * LDS + k0);
      const float4 o = *reinterpret_cast<const float4*>(dos + j * LD + 4 * cg);
      const float4 x = *reinterpret_cast<const float4*>(qs + j * LD + 4 * cg);
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        adv[i][0] = fmaf(p[i], o.x, adv[i][0]);
        adv[i][1] = fmaf(p[i], o.y, adv[i][1]);
        adv[i][2] = fmaf(p[i], o.z, adv[i][2]);
        adv[i][3] = fmaf(p[i], o.w, adv[i][3]);
        adk[i][0] = fmaf(ds[i], x.x, adk[i][0]);
        adk[i][1] = fmaf(ds[i], x.y, adk[i][1]);
        adk[i][2] = fmaf(ds[i], x.z, adk[i][2]);
        adk[i][3] = fmaf(ds[i], x.w, adk[i][3]);
      }
    }
    float one[RK], mul[RK];
#pragma unroll
    for (int i = 0; i < RK; ++i) one[i] = 1.0f, mul[i] = scale;
    row32::store_tile<1>(adv, one, dv + row_base, ldg, 0, k0, 4 * cg, T, DP);
    row32::store_tile<1>(adk, mul, dk + row_base, ldg, 0, k0, 4 * cg, T, DP);
  }
  K3_PHASE(0, 5);
}

// ---------------------------------------------------------------- route 2

// The dq kernel <DP, BQ, TK>: BQ query rows, whole rows of TK keys. Its
// ring's slots hold the score stages, KS keys x a DC-column chunk of D (the
// chunks of a key block in turn, so a slice's chain runs over D in order
// and the stage is KS keys wide for the 8 x 8 or 4 x 8 tile), or the dq
// stages, KSQ keys of the whole row. dq is split over SPLIT groups of
// threads, each one chain over its KSQ / SPLIT keys of every stage.
template <int DP, int BQ, int TK>
struct WideDq {
  static constexpr int S = Split<DP>::S, LD = Split<DP>::LD;
  // score tiles RM x RN (RN = KS / KGN), stages of KS keys x DC columns:
  // the widest stage the ring's two slots leave room for beside the rows
  // of s, in key blocks of TK / 4 keys or fewer (T = 257 computes 384)
  static constexpr bool NARROW = DP == 128 && TK == 1024;  // 16 rows, S = 2
  static constexpr int RM = NARROW ? 4 : 8;
  static constexpr int KS = TK == 256 ? 64 : NARROW ? 256 : 128;
  static constexpr int DC = TK == 256 ? 128 : NARROW ? 32 : 64;
  static constexpr int NC = DP / DC;
  static constexpr int LDC = DC + 4 * S;  // row stride of a score stage
  static constexpr int NST = TK / KS;      // key blocks of a whole row
  static constexpr int G = THREADS / BQ;   // threads on a row in the row pass
  static constexpr int LDS = score_ld(TK, G);
  static constexpr int RGN = BQ / RM, OWN = RM / S;
  using TL = Tile<S, RGN, THREADS>;
  static constexpr int KGN = TL::KGN, RN = KS / KGN;
  static_assert(KGN * RN == KS && TK % KS == 0, "score tiles cover a stage");
  static constexpr int KSQ = DP == 128 ? 64 : 32, SPLIT = BQ >= 32 ? 1 : DP == 128 ? 4 : 2;
  static constexpr int GT = THREADS / SPLIT, KQG = KSQ / SPLIT;  // a dq group's threads, keys
  static constexpr int CG = DP / 4, RS = GT / CG, RMO = BQ / RS;  // dq tiles
  static constexpr int SLOT = KS * LDC > KSQ * LD ? KS * LDC : KSQ * LD;
  static_assert((SPLIT - 1) * GT * RMO * 4 <= 2 * SLOT, "dq's partials fit the ring");
  static constexpr int DO = BQ * LD, RING = 2 * BQ * LD;
  static constexpr int SS = RING + 2 * SLOT, RED = SS + BQ * LDS;
  static constexpr size_t BYTES = 4 * size_t(RED + BQ * KGN);
};

template <int DP, int BQ, int TK>
__global__ void __launch_bounds__(THREADS, 1)
attn_wide_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ stats, int T, int H,
                        long ldq, long ldk, long ldv, long lddo, long ldg, float scale) {
  using L = WideDq<DP, BQ, TK>;
  constexpr int LD = L::LD, LDC = L::LDC, LDS = L::LDS, G = L::G, RM = L::RM, RN = L::RN;
  constexpr int OWN = L::OWN, RGN = L::RGN, KGN = L::KGN, KS = L::KS, DC = L::DC, NC = L::NC;
  constexpr int KSQ = L::KSQ;
  extern __shared__ __align__(16) float sm[];
  float *qs = sm, *dos = sm + L::DO, *ring = sm + L::RING, *ss = sm + L::SS, *red = sm + L::RED;
  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const long hd = long(h) * DP;
  const float* kb = k + long(n) * T * ldk + hd;
  const float* vb = v + long(n) * T * ldv + hd;
  // the ring's jobs, in order: the nst key blocks of k, chunk by chunk (s),
  // the same of v (dp), then the nsq stages of k (dq)
  const int nst = (T + KS - 1) / KS, nsq = (T + KSQ - 1) / KSQ, per = nst * NC;
  const int jobs = 2 * per + nsq;
  auto issue = [&](int g) {
    if (g < jobs) {
      float* dst = ring + (g & 1) * L::SLOT;
      if (g < 2 * per) {
        const int b = g % per, k0 = (b / NC) * KS, c0 = (b % NC) * DC;
        load_rows<DC, LDC, KS>(dst, (g < per ? kb : vb) + c0, g < per ? ldk : ldv, k0, T);
      } else {
        load_rows<DP, LD, KSQ>(dst, kb, ldk, (g - 2 * per) * KSQ, T);
      }
    }
    cp_async_commit();
  };
  K3_PHASE(1, 0);
  load_rows<DP, LD, BQ>(qs, q + long(n) * T * ldq + hd, ldq, q0, T);
  load_rows<DP, LD, BQ>(dos, dout + long(n) * T * lddo + hd, lddo, q0, T);
  cp_async_commit();
  issue(0);

  int rg, kg, sl;
  L::TL::at(threadIdx.x, rg, kg, sl);
  // one key block of a product A B^T (A: q or do), its NC chunks in turn
  int g = 0;
  auto block = [&](float (&acc)[RM][RN], const float* A) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;
#pragma unroll 1
    for (int cc = 0; cc < NC; ++cc, ++g) {
      K3_WAIT_BEGIN;
      cp_async_wait<0>();
      __syncthreads();  // stage g has landed; every thread is done with stage g - 1
      K3_WAIT_END(1);
      issue(g + 1);
      nt_split<DC, LD, LDC, L::S, RM, RN, RGN, KGN, false>(acc, A + cc * DC, rg,
                                                    ring + (g & 1) * L::SLOT, kg, sl);
    }
    reduce_scatter<L::S>(acc, sl);
  };
  // s = q k^T of the whole row into ss; keys past T -inf
  for (int b = 0; b < nst; ++b) {
    float acc[RM][RN];
    block(acc, qs);
#pragma unroll
    for (int i = 0; i < OWN; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int key = b * KS + kg + KGN * j;
        ss[(rg + RGN * (sl * OWN + i)) * LDS + key] = key < T ? acc[i][j] : -INFINITY;
      }
  }
  __syncthreads();
  K3_PHASE(1, 1);
  // the row pass (G threads a row, keys sub + G x, while the first stage of
  // v loads): m, e = exp(scale s - m), l, p = e / l in place
  {
    const int r = threadIdx.x / G, sub = threadIdx.x % G, keys = nst * KS;
    float* srow = ss + r * LDS;
    float mx = -INFINITY;
    for (int c = sub; c < keys; c += G) mx = fmaxf(mx, srow[c]);
    const float m = __fmul_rn(scale, group_max<G>(mx));
    float l = 0.0f;
    for (int c = sub; c < keys; c += G) {
      const float e = expf(fmaf(scale, srow[c], -m));
      srow[c] = e;
      l += e;
    }
    l = group_sum<G>(l);
    for (int c = sub; c < keys; c += G) srow[c] = srow[c] / l;
    if (sub == 0 && q0 + r < T) {
      const long nht = long(gridDim.z) * H * T;
      float* stp = stats + (long(n) * H + h) * T + q0 + r;
      stp[0] = m;
      stp[nht] = l;
    }
  }
  K3_PHASE(1, 2);
  // dp = do v^T into registers (the lane's own tile rows), and its partials
  // of delta: p dp over its keys in order (the first stage's barrier orders
  // the row pass's p before these reads)
  float dpr[L::NST][OWN][RN];
  float part[OWN];
#pragma unroll
  for (int i = 0; i < OWN; ++i) part[i] = 0.0f;
#pragma unroll
  for (int b = 0; b < L::NST; ++b) {
    if (b < nst) {
      float acc[RM][RN];
      block(acc, dos);
#pragma unroll
      for (int i = 0; i < OWN; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          dpr[b][i][j] = acc[i][j];
          const float p = ss[(rg + RGN * (sl * OWN + i)) * LDS + b * KS + kg + KGN * j];
          part[i] = fmaf(p, acc[i][j], part[i]);
        }
    }
  }
  K3_PHASE(1, 3);
#pragma unroll
  for (int i = 0; i < OWN; ++i) red[(rg + RGN * (sl * OWN + i)) * KGN + kg] = part[i];
  __syncthreads();
  // delta: the key groups' partials in order; ds = p (dp - delta) in place
  float delta[OWN];
#pragma unroll
  for (int i = 0; i < OWN; ++i) {
    const float* pr = red + (rg + RGN * (sl * OWN + i)) * KGN;
    delta[i] = pr[0];
#pragma unroll
    for (int w = 1; w < KGN; ++w) delta[i] += pr[w];
  }
#pragma unroll
  for (int b = 0; b < L::NST; ++b) {
    if (b < nst) {
#pragma unroll
      for (int i = 0; i < OWN; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          float& p = ss[(rg + RGN * (sl * OWN + i)) * LDS + b * KS + kg + KGN * j];
          p = p * (dpr[b][i][j] - delta[i]);
        }
    }
  }
  if (kg == 0) {
    const long nht = long(gridDim.z) * H * T;
    float* stp = stats + 2 * nht + (long(n) * H + h) * T + q0;
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      const int r = rg + RGN * (sl * OWN + i);
      if (q0 + r < T) stp[r] = delta[i];
    }
  }
  K3_PHASE(1, 4);
  // dq = scale ds k: group grp (GT threads) one chain over keys [KQG grp,
  // KQG (grp + 1)) of every stage, rows oy + RS i, 4 columns; the groups'
  // totals added in order
  const int grp = threadIdx.x / L::GT, t = threadIdx.x % L::GT;
  const int cg = t % L::CG, oy = t / L::CG;
  float acc[L::RMO][4];
#pragma unroll
  for (int i = 0; i < L::RMO; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  for (int st = 0; st < nsq; ++st, ++g) {
    K3_WAIT_BEGIN;
    cp_async_wait<0>();
    __syncthreads();  // the stage has landed, and every ds is written
    K3_WAIT_END(1);
    issue(g + 1);
    const int k0 = st * KSQ + grp * L::KQG;
    const int klen = min(L::KQG, (T - k0 + 3) & ~3);
    if (klen > 0)
      nn_rows<L::RMO, L::RS, LD>(acc, ss + k0, LDS, oy, ring + (g & 1) * L::SLOT + grp * L::KQG * LD,
                                 4 * cg, klen);
  }
  if constexpr (L::SPLIT > 1) {
    __syncthreads();  // every thread is done with the ring
    if (grp > 0) {
      float* mine = ring + ((grp - 1) * L::GT + t) * L::RMO * 4;
#pragma unroll
      for (int i = 0; i < L::RMO; ++i)
        *reinterpret_cast<float4*>(mine + 4 * i) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    if (grp == 0) {
#pragma unroll 1
      for (int o = 1; o < L::SPLIT; ++o) {
        const float* other = ring + ((o - 1) * L::GT + t) * L::RMO * 4;
#pragma unroll
        for (int i = 0; i < L::RMO; ++i) {
          const float4 b = *reinterpret_cast<const float4*>(other + 4 * i);
          acc[i][0] += b.x, acc[i][1] += b.y, acc[i][2] += b.z, acc[i][3] += b.w;
        }
      }
    }
  }
  K3_PHASE(1, 5);
  if (grp == 0) {
    float mul[L::RMO];
#pragma unroll
    for (int i = 0; i < L::RMO; ++i) mul[i] = scale;
    row32::store_tile<L::RS>(acc, mul, dq + long(n) * T * ldg + hd, ldg, q0, oy, 4 * cg, T, DP);
  }
  K3_PHASE(1, 6);
}

// acc[i][0..3] += sum_k A[r0 + RS i][k] B[k][c..c+3] and acc[i][4..7] the
// same at columns c + HALF .. + 3, k in order over [0, klen), klen % 4 == 0
template <int RM, int RS, int LDB, int HALF>
__device__ __forceinline__ void nn_rows8(float (&acc)[RM][8], const float* A, int lda, int r0,
                                         const float* B, int c, int klen) {
#pragma unroll 1
  for (int k = 0; k < klen; k += 4) {
    float4 a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (r0 + RS * i) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(B + (k + kk) * LDB + c);
      const float4 b1 = *reinterpret_cast<const float4*>(B + (k + kk) * LDB + c + HALF);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
        acc[i][0] = fmaf(av, b0.x, acc[i][0]);
        acc[i][1] = fmaf(av, b0.y, acc[i][1]);
        acc[i][2] = fmaf(av, b0.z, acc[i][2]);
        acc[i][3] = fmaf(av, b0.w, acc[i][3]);
        acc[i][4] = fmaf(av, b1.x, acc[i][4]);
        acc[i][5] = fmaf(av, b1.y, acc[i][5]);
        acc[i][6] = fmaf(av, b1.z, acc[i][6]);
        acc[i][7] = fmaf(av, b1.w, acc[i][7]);
      }
    }
  }
}

// The dk/dv kernel: k, v (BK rows each), two stages of a query chunk (q,
// do, then m, l, delta), p and ds (BK x CH each). Threads 0-127 form s^T
// and p, then dv; threads 128-255 dp^T and ds, then dk.
template <int DP>
struct WideDkdv {
  static constexpr int S = Split<DP>::S, LD = Split<DP>::LD;
  static constexpr int BK = DP <= 128 ? 64 : 32, CH = 32;
  static constexpr int RM = 8, RGN = BK / RM, OWN = RM / S;
  using TL = Tile<S, RGN, THREADS / 2>;
  static constexpr int KGN = TL::KGN, RN = CH / KGN;
  static_assert(KGN * RN == CH, "score tiles cover a chunk");
  static constexpr int LDP = CH + 4;
  // dk / dv: RMO key rows x 8 columns (4 cg .. + 3 and DP / 2 + 4 cg .. + 3)
  static constexpr int CG = DP / 8, RS = THREADS / 2 / CG, RMO = BK / RS;
  static constexpr int KROWS = BK * LD, QROWS = CH * LD;
  static constexpr int V = KROWS, STAGE0 = 2 * KROWS;
  static constexpr int STAGE = 2 * QROWS + 3 * CH;
  static constexpr int P = STAGE0 + 2 * STAGE, DS = P + BK * LDP;
  static constexpr size_t BYTES = 4 * size_t(DS + BK * LDP);
};

template <int DP>
__device__ __forceinline__ void load_chunk(float* stage, const float* qb, const float* db,
                                           const float* st, long nht, long ldq, long lddo,
                                           int c0, int T) {
  using L = WideDkdv<DP>;
  load_rows<DP, L::LD, L::CH>(stage, qb, ldq, c0, T);
  load_rows<DP, L::LD, L::CH>(stage + L::QROWS, db, lddo, c0, T);
  for (int id = threadIdx.x; id < 3 * L::CH; id += THREADS) {
    const int which = id / L::CH, r = id % L::CH;
    const bool ok = c0 + r < T;
    row32::cp_async4(stage + 2 * L::QROWS + id, ok ? st + which * nht + c0 + r : st, ok);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
attn_wide_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          float* __restrict__ dk, float* __restrict__ dv,
                          const float* __restrict__ stats, int T, int H, long ldq, long ldk,
                          long ldv, long lddo, long ldg, float scale) {
  using L = WideDkdv<DP>;
  constexpr int LD = L::LD, RM = L::RM, RN = L::RN, OWN = L::OWN, RMO = L::RMO, CH = L::CH;
  constexpr int RGN = L::RGN, KGN = L::KGN, LDP = L::LDP;
  extern __shared__ __align__(16) float sm[];
  float *ks = sm, *vs = sm + L::V, *ps = sm + L::P, *dss = sm + L::DS;
  const int n = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * L::BK;
  const long hd = long(h) * DP, nht = long(gridDim.z) * H * T;
  const float* qb = q + long(n) * T * ldq + hd;
  const float* db = dout + long(n) * T * lddo + hd;
  const float* st = stats + (long(n) * H + h) * T;
  const int chunks = (T + CH - 1) / CH;

  K3_PHASE(2, 0);
  load_rows<DP, LD, L::BK>(ks, k + long(n) * T * ldk + hd, ldk, k0, T);
  load_rows<DP, LD, L::BK>(vs, v + long(n) * T * ldv + hd, ldv, k0, T);
  load_chunk<DP>(sm + L::STAGE0, qb, db, st, nht, ldq, lddo, 0, T);
  cp_async_commit();
  if (chunks > 1) load_chunk<DP>(sm + L::STAGE0 + L::STAGE, qb, db, st, nht, ldq, lddo, CH, T);
  cp_async_commit();

  // s^T (threads 0-127) / dp^T (128-255) tiles: keys rg + RGN i, queries kg
  // + KGN j, D slice sl; then dv (0-127) / dk (128-255): keys oy + RS i
  const bool second = threadIdx.x >= THREADS / 2;  // warp-uniform
  const int t = threadIdx.x % (THREADS / 2);
  int rg, kg, sl;
  L::TL::at(t, rg, kg, sl);
  const int cg = t % L::CG, oy = t / L::CG;
  float acc[RMO][8];
#pragma unroll
  for (int i = 0; i < RMO; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    float* stage = sm + L::STAGE0 + (c & 1) * L::STAGE;
    const float *qc = stage, *dc = stage + L::QROWS, *sc = stage + 2 * L::QROWS;
    K3_WAIT_BEGIN;
    cp_async_wait<1>();
    __syncthreads();
    K3_WAIT_END(2);
    float s[RM][RN];  // s^T, or dp^T
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.0f;
    nt_split<DP, LD, LD, L::S, RM, RN, RGN, KGN>(s, second ? vs : ks, rg, second ? dc : qc, kg,
                                                 sl);
    reduce_scatter<L::S>(s, sl);
    if (!second) {
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = kg + KGN * j;
        const bool ok = c * CH + col < T;
        const float m = sc[col], l = sc[CH + col];
#pragma unroll
        for (int i = 0; i < OWN; ++i)  // the dq kernel's p: exp(scale s - m), one FMA, over l
          ps[(rg + RGN * (sl * OWN + i)) * LDP + col] =
              ok ? expf(fmaf(scale, s[i][j], -m)) / l : 0.0f;
      }
    }
    __syncthreads();  // every p is written
    if (second) {
      // ds = p (dp - delta), then dk += ds^T q once the second half's ds are
      // all written
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = kg + KGN * j;
        const bool ok = c * CH + col < T;
        const float delta = sc[2 * CH + col];
#pragma unroll
        for (int i = 0; i < OWN; ++i) {
          const int at = (rg + RGN * (sl * OWN + i)) * LDP + col;
          dss[at] = ok ? ps[at] * (s[i][j] - delta) : 0.0f;
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS / 2) : "memory");
      nn_rows8<RMO, L::RS, LD, DP / 2>(acc, dss, LDP, oy, qc, 4 * cg, CH);
    } else {
      nn_rows8<RMO, L::RS, LD, DP / 2>(acc, ps, LDP, oy, dc, 4 * cg, CH);  // dv += p^T do
    }
    __syncthreads();  // the stage and p / ds are free again
    if (c + 2 < chunks) load_chunk<DP>(stage, qb, db, st, nht, ldq, lddo, (c + 2) * CH, T);
    cp_async_commit();
  }
  K3_PHASE(2, 1);
  float* out = (second ? dk : dv) + long(n) * T * ldg + hd;
  const float mul = second ? scale : 1.0f;
#pragma unroll
  for (int i = 0; i < RMO; ++i) {
    const int r = k0 + oy + L::RS * i;
    if (r < T) {
      float* o = out + long(r) * ldg + 4 * cg;
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[i][0] * mul, acc[i][1] * mul, acc[i][2] * mul, acc[i][3] * mul);
      *reinterpret_cast<float4*>(o + DP / 2) =
          make_float4(acc[i][4] * mul, acc[i][5] * mul, acc[i][6] * mul, acc[i][7] * mul);
    }
  }
  K3_PHASE(2, 2);
}

// ---------------------------------------------------------------- launch

template <int DP, int TK>
cudaError_t launch_short(const float* q, const float* k, const float* v, const float* dout,
                         float* dq, float* dk, float* dv, int N, int T, int H, long ldq, long ldk,
                         long ldv, long lddo, long ldg, cudaStream_t s) {
  using L = Short<DP, TK>;
  static_assert(L::BYTES <= size_t(ATT_MAX_SMEM), "K3's one-pass tiles exceed shared memory");
  auto kernel = attn_wide_bwd_short_kernel<DP, TK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(L::BYTES));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, N), THREADS, L::BYTES, s>>>(q, k, v, dout, dq, dk, dv, T, ldq, ldk, ldv, lddo,
                                               ldg, 1.0f / sqrtf(float(DP)));
  return cudaGetLastError();
}

template <int DP, int BQ, int TK>
cudaError_t launch_split(const float* q, const float* k, const float* v, const float* dout,
                         float* dq, float* dk, float* dv, float* stats, int N, int T, int H,
                         long ldq, long ldk, long ldv, long lddo, long ldg, cudaStream_t s) {
  using LQ = WideDq<DP, BQ, TK>;
  using LK = WideDkdv<DP>;
  static_assert(LQ::BYTES <= size_t(ATT_MAX_SMEM) && LK::BYTES <= size_t(ATT_MAX_SMEM),
                "K3 tiles exceed shared memory");
  auto k_dq = attn_wide_bwd_dq_kernel<DP, BQ, TK>;
  auto k_dkdv = attn_wide_bwd_dkdv_kernel<DP>;
  cudaError_t err =
      cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, int(LQ::BYTES));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(LK::BYTES));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(float(DP));
  dim3 grid_dq((T + BQ - 1) / BQ, H, N), grid_dkdv((T + LK::BK - 1) / LK::BK, H, N);
  k_dq<<<grid_dq, THREADS, LQ::BYTES, s>>>(q, k, v, dout, dq, stats, T, H, ldq, ldk, ldv, lddo,
                                           ldg, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k_dkdv<<<grid_dkdv, THREADS, LK::BYTES, s>>>(q, k, v, dout, dk, dv, stats, T, H, ldq, ldk, ldv,
                                               lddo, ldg, scale);
  return cudaGetLastError();
}

}  // namespace wide32

// the route by shape (flash_attention.f32_k3_route mirrors it)
cudaError_t launch_attn_bwd_wide_f32(const float* q, const float* k, const float* v,
                                     const float* dout, float* dq, float* dk, float* dv,
                                     float* stats, int N, int T, int H, int D, long ldq, long ldk,
                                     long ldv, long lddo, long ldg, cudaStream_t s) {
  using namespace wide32;
  if (N < 1 || H < 1 || T < 1 || T > long32::MAX_T || (D != 128 && D != 256))
    return cudaErrorInvalidValue;
  if (D == 128) {
    if (T <= 16)
      return launch_short<128, 16>(q, k, v, dout, dq, dk, dv, N, T, H, ldq, ldk, ldv, lddo, ldg, s);
    if (T <= 32)
      return launch_short<128, 32>(q, k, v, dout, dq, dk, dv, N, T, H, ldq, ldk, ldv, lddo, ldg, s);
    if (T <= 64)
      return launch_short<128, 64>(q, k, v, dout, dq, dk, dv, N, T, H, ldq, ldk, ldv, lddo, ldg, s);
    if (T <= 256)
      return launch_split<128, 64, 256>(q, k, v, dout, dq, dk, dv, stats, N, T, H, ldq, ldk,
                                            ldv, lddo, ldg, s);
    if (T <= 512)
      return launch_split<128, 32, 512>(q, k, v, dout, dq, dk, dv, stats, N, T, H, ldq, ldk,
                                            ldv, lddo, ldg, s);
    return launch_split<128, 16, 1024>(q, k, v, dout, dq, dk, dv, stats, N, T, H, ldq, ldk,
                                            ldv, lddo, ldg, s);
  }
  if (T <= 16)
    return launch_short<256, 16>(q, k, v, dout, dq, dk, dv, N, T, H, ldq, ldk, ldv, lddo, ldg, s);
  if (T <= 32)
    return launch_short<256, 32>(q, k, v, dout, dq, dk, dv, N, T, H, ldq, ldk, ldv, lddo, ldg, s);
  if (T <= 48)
    return launch_short<256, 48>(q, k, v, dout, dq, dk, dv, N, T, H, ldq, ldk, ldv, lddo, ldg, s);
  if (T <= 256)
    return launch_split<256, 32, 256>(q, k, v, dout, dq, dk, dv, stats, N, T, H, ldq, ldk,
                                          ldv, lddo, ldg, s);
  return launch_split<256, 16, 1024>(q, k, v, dout, dq, dk, dv, stats, N, T, H, ldq, ldk, ldv,
                                         lddo, ldg, s);
}

}  // namespace lfm
