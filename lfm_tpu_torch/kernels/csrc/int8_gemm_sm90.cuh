// P1's int8 GEMM for Hopper (sm_90a) on s8 wgmma and TMA:
//   out (M, N) = epilogue(A (M, K) . W (N, K)^T),  A, W int8, sums in int32
// the int8 product of tools/microbench_int8_pallas.py::_kernel_int8 (run_int8,
// :92) and of the path it models, lfm_tpu/nn/dit_int8.py::_dense_int8 (:130),
// with its dequant in their f32 order (dit_int8.py:130-140, 215, 223):
//   value = __int2float_rn(acc) * sa[m] * sw[n]   (each product __fmul_rn)
//   value = value + bias[n]                       (__fadd_rn; a null bias adds nothing)
//   value = gelu_tanh_torch(value)                (fc1 only)
// stored as f32 or bf16. The products and the sum are rounded one by one, so
// that nvcc does not contract them into an FMA: the values are JAX's, and the
// int32 sums are exact in any order (127^2 * 4096 < 2^31), so the outputs
// equal the plain version's (kernels/int8_matmul.py) bit for bit.
//
// What bounds it on the H100: the int8 path's four products at N = 200, T =
// 256 (M = 51200), C = 1024, hidden 4096 are 2 M C (3C + C + 4C + 4C) = 1.29
// TOP, 0.65 ms at the 1979 TOP/s dense int8 peak; fc1's f32 output alone is
// 839 MB, 0.25 ms at 3.35 TB/s, against its 0.217 ms of operations, so fc1
// and fc2 sit at the ridge and qkv and proj are bound by operations. Only
// s8 wgmma reaches that rate (mma.sync, the WMMA kernel this replaces, ran
// at ~150 TOP/s, 7% of it), fed from swizzled shared memory with loads in
// flight.
//
// Design, gemm_sm90.cuh's GEMM with int8 operands. A and W are both K-major,
// the only layout s8 wgmma takes from shared memory. A CTA of three
// warpgroups walks output tiles persistently (grid = min(tiles, SMs), CTA b
// takes tiles b, b + grid, ... in an M band across its N tiles, so W stays
// in L2), in steps of k = 128 (one 128-byte swizzle row of int8):
//  - producer: warpgroup 0 gives up registers (setmaxnreg 40) and one thread
//    issues the TMA loads of A's box and W's BN x 128 box into a ring of
//    slots with the 128-byte swizzle (rows past M and columns past K
//    zero-filled: K % 128 == 64 ends in a half slot of zeros). Each slot has
//    a full mbarrier (the loads' bytes) and an empty one (the consumer warps
//    that read it), phase parity = the slot's use count & 1;
//  - consumers: warpgroups 1 and 2 (setmaxnreg 232) take 64 rows each of a
//    128 x BN tile (BN 256, or 128 where N % 256 != 0), hold its 128 (64)
//    s32 accumulators a thread and issue four wgmma.m64n{BN}k32.s32.s8.s8 a
//    slot (the descriptor's start 32 bytes further per k32), keep one group
//    in flight, and release a slot once the group after it is issued (a
//    slot is empty after all 8 consumer warps);
//  - epilogue from registers: the dequant, bias and GELU of an output box's
//    columns (64 rows x 128 bytes: 64 bf16 or 32 f32 columns), their scale
//    and bias pairs loaded first, written to shared memory in the output
//    map's 128-byte swizzle and stored by one thread with TMA, which clips
//    rows >= M (gemm_sm90.cuh's store_box). The warpgroup goes on to its
//    next tile while the stores drain.
// The launcher (int8_gemm.cu) takes N % 128 == 0 and K % 64 == 0, any M >=
// 1. At the int8 path's four products (M = 51200) it runs qkv in 0.287 ms
// (1123 TOP/s) and fc1 in 0.682 (an H100 SXM at 700 W, tools/bench_int8.py).
// A ping-pong schedule (each warpgroup on its own tile, so that one's
// epilogue runs under the other's products) was faster at proj and fc2 alone
// but moved the int8 evaluation and sampling by less than their run-to-run
// spread, so the kernel keeps one schedule (PERF.md). What it does not hide
// is fc1's epilogue, its GELU and 839 MB of f32 stores after each tile.
#pragma once

#include "gemm_sm90.cuh"

namespace lfm {

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

namespace sm90 {

constexpr int I8_BK = 128;  // k of a ring slot: one 128-byte swizzle row of int8

template <int BN>
struct Int8Ring {
  static constexpr int TILE_M = 128;  // rows of a tile, 64 a consumer warpgroup
  static constexpr uint32_t A_BYTES = TILE_M * I8_BK;
  static constexpr uint32_t STAGE = A_BYTES + BN * I8_BK;  // multiples of 1024
  static constexpr int BARRIERS = 2 * 8 * 8;               // a full and an empty one a slot
  // as many slots as fit beside two 8 KB output boxes of each consumer
  // warpgroup, the barriers and the 1024-byte alignment (232,448 bytes): 4
  // at BN 256, 6 at 128
  static constexpr int STAGES = (232448 - 1024 - 4 * int(STAGE_BOX) - BARRIERS) / int(STAGE);
  static_assert(STAGES <= 8, "room for 8 slots' barriers");
  static constexpr int SMEM = 1024 + STAGES * STAGE + 4 * STAGE_BOX + BARRIERS;
};

struct Int8Args {
  const float* sa;    // (M) row scales of A
  const float* sw;    // (N) column scales of W
  const bf16* bias;   // (N) or null
  int M, N, K;
};

// D (64 x N, s32) (+)= A (64 x 32) . B (N x 32)^T, both int8 K-major in
// shared memory, given by the low words of their descriptors and the shared
// high word; acc = 0 overwrites D
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint32_t a, uint32_t b, uint32_t hi,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %67, 0;\n"
        "mov.b64 da, {%64, %66};\n"
        "mov.b64 db, {%65, %66};\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "da, db, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a), "r"(b), "r"(hi), "r"(acc));
  }
};

template <>
struct WgmmaS8<256> {
  static __device__ __forceinline__ void run(int (&d)[128], uint32_t a, uint32_t b, uint32_t hi,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %131, 0;\n"
        "mov.b64 da, {%128, %130};\n"
        "mov.b64 db, {%129, %130};\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "da, db, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
          "+r"(d[126]), "+r"(d[127])
        : "r"(a), "r"(b), "r"(hi), "r"(acc));
  }
};

// The epilogue of rows [m_base, m_base + 64) x columns [n0, n0 + BN) from a
// consumer warpgroup's accumulators: thread `lane` of warp w holds, for n8
// block i, columns n0 + 8i + 2 (lane % 4) + {0, 1} of row m_base + 16w +
// lane / 4 (acc[4i], acc[4i + 1]) and of the row 8 below (acc[4i + 2, 3]).
// One output box at a time: its column scales and bias pairs loaded, its
// values computed into v and stored by store_box.
template <int BN, bool GELU, typename TOut>
__device__ __forceinline__ void int8_epilogue(const int (&acc)[BN / 2], BoxStager& st,
                                              int m_base, int n0, const Int8Args& g,
                                              const CUtensorMap* t_out) {
  constexpr int NI = 128 / 8 / int(sizeof(TOut));  // n8 blocks of an output box
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int r0 = m_base + 16 * warp + lane / 4, c0 = n0 + 2 * (lane % 4);
  // rows >= M are never stored (the map clips them); their scale is 0
  const float s_row[2] = {r0 < g.M ? g.sa[r0] : 0.0f, r0 + 8 < g.M ? g.sa[r0 + 8] : 0.0f};
#pragma unroll
  for (int i0 = 0; i0 < BN / 8; i0 += NI) {
    float2 sw[NI], b[NI];
#pragma unroll
    for (int ii = 0; ii < NI; ++ii) {
      sw[ii] = load_pair(g.sw + c0 + 8 * (i0 + ii));
      b[ii] = g.bias ? load_pair(g.bias + c0 + 8 * (i0 + ii)) : make_float2(0.0f, 0.0f);
    }
    float v[4 * NI];
#pragma unroll
    for (int ii = 0; ii < NI; ++ii)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, odd = e % 2;
        float val = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * (i0 + ii) + e]), s_row[h]),
                              odd ? sw[ii].y : sw[ii].x);
        if (g.bias) val = __fadd_rn(val, odd ? b[ii].y : b[ii].x);
        if constexpr (GELU) val = gelu_tanh_torch(val);
        v[4 * ii + e] = val;
      }
    store_box<TOut>(st, t_out, v, 0, n0 + 8 * i0, m_base);
  }
}

template <int BN, bool GELU, typename TOut>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
int8_gemm_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tw,
                      const __grid_constant__ CUtensorMap t_out, const Int8Args g) {
  using R = Int8Ring<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms need 1024 B
  const uint32_t staging = ring + R::STAGES * R::STAGE;       // 2 x 2 boxes
  const uint32_t full = staging + 4 * STAGE_BOX, empty = full + 8 * R::STAGES;
  const int n_tiles = g.N / BN;
  const int tiles = (g.M + R::TILE_M - 1) / R::TILE_M * n_tiles;
  const int k_steps = (g.K + I8_BK - 1) / I8_BK;
  const int wg = threadIdx.x / GEMM_WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // the consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: the CTA's tiles in order
    setmaxnreg_dec<GEMM_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;  // ring use, over all of this CTA's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * R::TILE_M, n0 = tile % n_tiles * BN;
        for (int kt = 0; kt < k_steps; ++kt, ++it) {
          const int s = it % R::STAGES;
          if (it >= R::STAGES) mbar_wait(empty + 8 * s, (it / R::STAGES - 1) & 1);
          const uint32_t slot = ring + s * R::STAGE;
          mbar_expect_tx(full + 8 * s, R::STAGE);  // zero-filled bytes count too
          tma_load_2d(slot, &ta, full + 8 * s, kt * I8_BK, m0);
          tma_load_2d(slot + R::A_BYTES, &tw, full + 8 * s, kt * I8_BK, n0);
        }
      }
    }
  } else {  // consumers: rows 64 (wg - 1) .. of every tile
    setmaxnreg_inc<GEMM_CONSUMER_REGS>();
    const int lane = threadIdx.x % 32, row_off = (wg - 1) * 64;
    constexpr uint32_t hi = desc_hi_bits(1024, 1);  // 8 rows of 128 bytes, 128-byte swizzle
    int acc[BN / 2];
    BoxStager st{staging + (wg - 1) * 2 * STAGE_BOX, 0, wg, threadIdx.x % GEMM_WG == 0};
    int it = 0;  // ring use, as the producer counts it
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * R::TILE_M, n0 = tile % n_tiles * BN;
      for (int kt = 0; kt < k_steps; ++kt, ++it) {
        const int s = it % R::STAGES;
        mbar_wait(full + 8 * s, (it / R::STAGES) & 1);
        const uint32_t a = ring + s * R::STAGE + row_off * I8_BK;
        const uint32_t b = ring + s * R::STAGE + R::A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < I8_BK / 32; ++kk)
          WgmmaS8<BN>::run(acc, desc_lo_bits(a + 32 * kk, 16), desc_lo_bits(b + 32 * kk, 16), hi,
                           kt > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's group is done: its slot is free
        if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % R::STAGES));
      }
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % R::STAGES));
      int8_epilogue<BN, GELU, TOut>(acc, st, m0 + row_off, n0, g, &t_out);
    }
    if (st.leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

}  // namespace sm90
}  // namespace lfm
