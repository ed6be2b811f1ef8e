// The GEMM of K2 (dit_block.cu), K5 (dit_block_train.cu) and P1-bf16's
// lfm_bf16_mlp (int8_gemm.cu), for Hopper (sm_90a) on wgmma and TMA, in
// three layouts of bf16 row-major operands (gemm.cuh's LAYOUT_*):
//   NT  out (M, N) = epilogue(A (M, K) . W (N, K)^T)  a torch.nn.Linear forward
//   NN  out (M, N) = epilogue(A (M, K) . B (K, N))    an activation gradient
//   TN  out (M, N) = epilogue(A (K, M)^T . B (K, N))  a weight gradient, summed
//                                                      over all K token rows
// NT's operands are both K-major, the layout wgmma's shared-memory operands
// take with no transpose; NN's B and TN's A and B are MN-major, which wgmma
// reads for bf16 with its transpose bits. It computes the products of
// lfm_tpu/kernels/dit_block.py::_dit_block_kernel (dit_block.py:67-132) and
// of `_fwd_kernel` and `_mlp_bwd_kernel` (lfm_tpu/kernels/dit_block_train.py)
// at their rounding points: the product summed in f32, then in f32
// (gemm.cuh's epilogues)
//   KIND_BIAS   out = value + bias                  (EPI_BIAS; EPI_STORE: no bias)
//   KIND_GELU   aux = bf16(value + bias) if aux is set; out = gelu_tanh(value + bias)
//                                                   (EPI_GELU, EPI_GELU_AUX)
//   KIND_GATED  aux = bf16(value + bias) if aux is set; out = f32(resid) +
//               f32(mod[m / T, gate * N + n]) * (value + bias); aux2 = bf16(out)
//               if aux2 is set                      (EPI_GATED, EPI_GATED_AUX)
//   KIND_DGELU  du = value * gelu_tanh'(f32(u[m, n])); out = du; aux =
//               bf16(gelu_tanh(f32(u))) if aux is set (one tanh for both);
//               part[m / 128, n] = the f32 sum of du over the tile's 128
//               rows (EPI_DGELU)
// a null bias adding nothing, and out rounded once to TOut (bf16 or f32);
// resid is TRes (bf16 or f32). The instances are those the callers use: NT
// KIND_BIAS and KIND_GELU into bf16, KIND_GATED bf16 -> f32 and f32 -> bf16;
// NN KIND_DGELU into bf16 and KIND_BIAS (no bias) into f32 and bf16; TN
// KIND_BIAS (no bias) into f32.
//
// What bounds it on the H100: K2's four products at N = 200, T = 256 (M =
// 51200), C = 1024, hidden 4096 are 2 M C (3C + C + 4C + 4C) = 1.288 TFLOP,
// 1.30 ms at 989 TFLOP/s, against about 1.4 GB of operands, results and
// residuals, 0.42 ms at 3.35 TB/s: bound by tensor-core operations. So are
// K5's MLP backward's four (NN du, TN dW2, NN dh, TN dW1): each 2 M C
// hidden = 68.7 GFLOP at N = 32 (M = 8192), 69 us, against at most 100 MB
// (du's u, out and gb), 30 us. Only wgmma reaches that rate (mma.sync, the WMMA
// kernels this replaces, ran at ~140 TFLOP/s), fed from swizzled shared
// memory with loads in flight.
//
// Design. A CTA of three warpgroups computes 128 x BN output tiles (BN 256,
// or 128 where N % 256 != 0 or where 128-wide tiles fill the SMs in fewer
// waves of work), walking k in steps of 64 (one 128-byte swizzle row of
// bf16):
//  - producer: warpgroup 0 gives up registers (setmaxnreg) and one thread
//    issues the TMA loads of A's 128 x 64 tile and B's BN x 64 tile into a
//    ring of STAGES slots (4 of 48 KB at BN 256, 6 of 32 KB at BN 128), 2-D
//    tensor maps with the 128-byte swizzle, in boxes of the stored layout: a
//    K-major operand as one box of its rows x 64 k, an MN-major one as boxes
//    of 64 k rows x 64 columns (128 bytes), 8 KB apart. Loads past M, N or K
//    are zero-filled, so K need not be a multiple of 64. Each slot has a
//    full mbarrier (the loads' bytes) and an empty one (the 8 consumer
//    warps), phase parity = the slot's use count & 1;
//  - consumers: warpgroups 1 and 2 take 64 rows each and run
//    wgmma.m64n{BN}k16 from the slot, keep one group in flight, and release
//    a slot once the group after it is issued. Descriptors (128-byte
//    swizzle, SBO 1024: 8 rows of 128 bytes): K-major, the start 32 bytes
//    further per k16; MN-major, the start 2048 bytes (16 k rows) further
//    per k16 and LBO 8192 between 64-column boxes;
//  - persistent: grid = min(tiles, SMs); CTA b takes tiles b, b + grid, ...
//    in an M band across its N tiles, so the band's A rows are read from L2
//    by the CTAs beside it and B (at most 8 MB) stays in L2. A weight
//    gradient at N = 32 (M = C 1024 or hidden 4096) has 128 tiles of 128 x
//    256 for 132 SMs, each walking all 8192 token rows: no split of K, whose
//    partials (8 splits of a 1024 x 4096 f32 gradient write and read 134
//    MB, ~80 us) would cost more than the GEMM's own bound;
//  - epilogue: each thread holds, per n8 block, two adjacent columns of two
//    rows (the accumulator layout of wgmma m64nN). The bias is added in
//    place (all its loads in flight at once), GELU, its derivative or the
//    gate computed in f32 (u's pairs loaded two 64-column groups ahead; the
//    gate's resid and mod pairs 64 columns at a time, before any store that
//    could alias them), and every output leaves as boxes of 64 rows x 128
//    bytes: written to shared memory in the 128-byte swizzle of the
//    output's tensor map (two 8 KB buffers per consumer warpgroup) and
//    stored by one thread with TMA, which clips rows >= M. The warpgroup
//    goes on to the next tile while the stores drain, and the producer has
//    already filled the ring with that tile's first k steps. KIND_DGELU's
//    column sums run in a fixed order
//    (dgelu_column_sums), with no atomics, so every output is the same bits
//    from run to run.
//    Without the epilogue the main loop ran ~835 TFLOP/s at K = 1024 (an
//    H100 SXM at 700 W, tools/bench_block.py's GEMM rows); what the
//    epilogue still costs (GELU's tanhf, the gate's loads) is not
//    overlapped with the tensor cores.
// The launchers (gemm_sm90.cu: NT; gemm_sm90_bwd.cu: NN, TN) refuse N % 128
// != 0, and NT K % 64 != 0; every DiT configuration has C and hidden
// multiples of 128.
#pragma once

#include "gemm.cuh"
#include "sm90.cuh"

namespace lfm {
namespace sm90 {

constexpr int GEMM_BM = 128;       // rows of a tile: 64 per consumer warpgroup
constexpr int GEMM_BK = 64;        // k of a ring slot: one 128-byte swizzle row of bf16
constexpr int GEMM_WG = 128;       // threads of a warpgroup
constexpr int GEMM_THREADS = 3 * GEMM_WG;
constexpr int GEMM_CONSUMER_WARPS = 8;
constexpr int GEMM_PRODUCER_REGS = 40, GEMM_CONSUMER_REGS = 232;  // 128*40 + 256*232 <= 64K

enum { KIND_BIAS = 0, KIND_GELU = 1, KIND_GATED = 2, KIND_DGELU = 3 };

template <int BN>
struct GemmRing {
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr uint32_t A_BYTES = GEMM_BM * GEMM_BK * 2;
  static constexpr uint32_t STAGE = A_BYTES + BN * GEMM_BK * 2;  // multiples of 1024
  // the ring, two 8 KB output boxes per consumer warpgroup, the barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE + 4 * 64 * 128 + 2 * 8 * STAGES;
};

struct GemmArgs {
  const bf16* bias;   // (N) or null
  void* out;          // (M, N) TOut
  const void* resid;  // KIND_GATED: (M, N) TRes
  const bf16* mod;    // KIND_GATED: (M / T, 6N), the gate at column gate * N + n
  bf16* aux;          // KIND_GELU, KIND_GATED, KIND_DGELU: (M, N) or null
  bf16* aux2;         // KIND_GATED: (M, N) or null
  const bf16* u;      // KIND_DGELU: (M, N), the fc1 pre-activation
  float* part;        // KIND_DGELU: (ceil(M / 128), N) column sums
  int M, N, K, T, gate;
};

// D (64 x N, f32) (+)= A (64 x 16) . B (16 x N) from shared memory, given by
// the low words of their descriptors and the shared high word; acc = 0
// overwrites D. TA / TB = 0: the operand is K-major (A (64 x 16) and B^T (N x
// 16) row-major); 1: MN-major (A^T (16 x 64) and B (16 x N) row-major), the
// transpose bits of wgmma for bf16
template <int N, int TA = 0, int TB = 0>
struct WgmmaSS;

template <int TA, int TB>
struct WgmmaSS<128, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[64], uint32_t a, uint32_t b, uint32_t hi,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %67, 0;\n"
        "mov.b64 da, {%64, %66};\n"
        "mov.b64 db, {%65, %66};\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "da, db, p, 1, 1, %68, %69;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a), "r"(b), "r"(hi), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct WgmmaSS<256, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[128], uint32_t a, uint32_t b, uint32_t hi,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %131, 0;\n"
        "mov.b64 da, {%128, %130};\n"
        "mov.b64 db, {%129, %130};\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
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
        "da, db, p, 1, 1, %132, %133;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a), "r"(b), "r"(hi), "r"(acc), "n"(TA), "n"(TB));
  }
};


__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st_shared_pair(uint32_t addr, float a, float b, bf16*) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<const uint32_t*>(&v)));
}
__device__ __forceinline__ void st_shared_pair(uint32_t addr, float a, float b, float*) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b));
}
// the warpgroup's 128 threads (named barrier `id`)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// A consumer warpgroup's outputs leave through shared memory: a box of its
// 64 rows x 128 bytes (64 bf16 or 32 f32 columns) is written into one of
// two 8 KB buffers in the 128-byte swizzle of the output's tensor map, and
// one thread stores it with TMA (rows >= M are clipped) while the
// warpgroup goes on. Before a buffer is written again, that thread waits
// until the store issued from it two boxes earlier has read it.
struct BoxStager {
  uint32_t buf;  // the warpgroup's two buffers
  int count;     // boxes staged so far; this one goes to buffer count % 2
  int bar;       // the warpgroup's named barrier
  bool leader;   // thread 0 of the warpgroup
};

constexpr uint32_t STAGE_BOX = 64 * 128;  // bytes of a box
constexpr int EPI_GROUP = 8;              // n8 blocks of a 64-column group (gated epilogue)

// acc's n8 blocks [i0, i0 + 128 / 8 / sizeof(T)) as T, to columns [col0, ...)
// of rows [row0, row0 + 64) through `map`
template <typename T, int NACC>
__device__ __forceinline__ void store_box(BoxStager& st, const CUtensorMap* map,
                                          const float (&acc)[NACC], int i0, int col0,
                                          int row0) {
  constexpr int NI = 128 / 8 / int(sizeof(T));
  const uint32_t buf = st.buf + (st.count & 1) * STAGE_BOX;
  if (st.count >= 2) {
    if (st.leader) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    warpgroup_sync(st.bar);
  }
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
#pragma unroll
  for (int ii = 0; ii < NI; ++ii)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = 16 * warp + lane / 4 + 8 * h;
      const uint32_t byte = (8 * ii + 2 * (lane % 4)) * sizeof(T);
      st_shared_pair(buf + rr * 128 + ((((byte >> 4) ^ (lane / 4)) & 7) << 4) + (byte & 15),
                     acc[4 * (i0 + ii) + 2 * h], acc[4 * (i0 + ii) + 2 * h + 1],
                     static_cast<T*>(nullptr));
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
  warpgroup_sync(st.bar);
  if (st.leader) {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
        "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(buf), "r"(col0), "r"(row0)
        : "memory");
  }
  ++st.count;
}

// The epilogue of rows [m_base, m_base + 64) x columns [n0, n0 + BN) from a
// consumer warpgroup's accumulators: thread `lane` of warp w holds, for n8
// block i, columns n0 + 8i + 2 (lane % 4) + {0, 1} of row m_base + 16w +
// lane / 4 (acc[4i], acc[4i + 1]) and of the row 8 below (acc[4i + 2, 3]).
// The bias loads are all issued before any use, the gated epilogue's resid
// and gate loads a 64-column group at a time; each value is computed in
// place in acc and leaves by store_box.
template <int KIND, int BN, typename TRes, typename TOut>
__device__ __forceinline__ void gemm_epilogue(float (&acc)[BN / 2], BoxStager& st, int m_base,
                                              int n0, const GemmArgs& g,
                                              const CUtensorMap* t_out, const CUtensorMap* t_aux,
                                              const CUtensorMap* t_aux2) {
  constexpr int OUT_NI = 128 / 8 / int(sizeof(TOut));  // n8 blocks of an output box
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int r0 = m_base + 16 * warp + lane / 4, c0 = n0 + 2 * (lane % 4);
  if (g.bias) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float2 b = load_pair(g.bias + c0 + 8 * i);
      acc[4 * i] += b.x;
      acc[4 * i + 1] += b.y;
      acc[4 * i + 2] += b.x;
      acc[4 * i + 3] += b.y;
    }
  }
  if constexpr (KIND == KIND_BIAS) {
#pragma unroll
    for (int i0 = 0; i0 < BN / 8; i0 += OUT_NI)
      store_box<TOut>(st, t_out, acc, i0, n0 + 8 * i0, m_base);
  } else if constexpr (KIND == KIND_GELU) {
#pragma unroll
    for (int i0 = 0; i0 < BN / 8; i0 += OUT_NI) {
      if (g.aux) store_box<bf16>(st, t_aux, acc, i0, n0 + 8 * i0, m_base);
#pragma unroll
      for (int e = 4 * i0; e < 4 * (i0 + OUT_NI); ++e) acc[e] = gelu_tanh(acc[e]);
      store_box<TOut>(st, t_out, acc, i0, n0 + 8 * i0, m_base);
    }
  } else if constexpr (KIND == KIND_DGELU) {
    // u's bf16 pairs two 64-column groups ahead: the loads of group i + 2
    // are issued once group i's are read
    const bool row_ok[2] = {r0 < g.M, r0 + 8 < g.M};
    __nv_bfloat162 up[2][EPI_GROUP][2];
    auto load_u = [&](__nv_bfloat162 (&dst)[EPI_GROUP][2], int i0) {
#pragma unroll
      for (int j = 0; j < EPI_GROUP; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          dst[j][h] = row_ok[h] ? *reinterpret_cast<const __nv_bfloat162*>(
                                      g.u + long(r0 + 8 * h) * g.N + c0 + 8 * (i0 + j))
                                : __floats2bfloat162_rn(0.0f, 0.0f);
    };
    load_u(up[0], 0);
    load_u(up[1], EPI_GROUP);
#pragma unroll
    for (int i0 = 0; i0 < BN / 8; i0 += EPI_GROUP) {
      __nv_bfloat162 (&cur)[EPI_GROUP][2] = up[(i0 / EPI_GROUP) % 2];
      float gl[4 * EPI_GROUP];  // gelu(u) of the group's n8 blocks, for aux
#pragma unroll
      for (int j = 0; j < EPI_GROUP; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows past M hold 0: their A rows are zero-filled
          const int e = 4 * (i0 + j) + 2 * h;
          const float2 uv = __bfloat1622float2(cur[j][h]);
          const float t0 = gelu_tanh_t(uv.x), t1 = gelu_tanh_t(uv.y);
          gl[4 * j + 2 * h] = gelu_tanh(uv.x, t0);
          gl[4 * j + 2 * h + 1] = gelu_tanh(uv.y, t1);
          acc[e] = row_ok[h] ? acc[e] * gelu_tanh_grad(uv.x, t0) : 0.0f;
          acc[e + 1] = row_ok[h] ? acc[e + 1] * gelu_tanh_grad(uv.y, t1) : 0.0f;
        }
      if (i0 + 2 * EPI_GROUP < BN / 8) load_u(cur, i0 + 2 * EPI_GROUP);
      if (g.aux) store_box<bf16>(st, t_aux, gl, 0, n0 + 8 * i0, m_base);
#pragma unroll
      for (int k = 0; k < EPI_GROUP; k += OUT_NI)
        store_box<TOut>(st, t_out, acc, i0 + k, n0 + 8 * (i0 + k), m_base);
    }
  } else {
    const TRes* resid = static_cast<const TRes*>(g.resid);
    const bool row_ok[2] = {r0 < g.M, r0 + 8 < g.M};
    const bf16* gate[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      gate[h] = g.mod + long((row_ok[h] ? r0 + 8 * h : 0) / g.T) * 6 * g.N +
                long(g.gate) * g.N + c0;
#pragma unroll
    for (int i0 = 0; i0 < BN / 8; i0 += EPI_GROUP) {
      float2 rv[EPI_GROUP][2], gv[EPI_GROUP][2];
#pragma unroll
      for (int j = 0; j < EPI_GROUP; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rv[j][h] = gv[j][h] = make_float2(0.0f, 0.0f);
          if (!row_ok[h]) continue;
          rv[j][h] = load_pair(resid + long(r0 + 8 * h) * g.N + c0 + 8 * (i0 + j));
          gv[j][h] = load_pair(gate[h] + 8 * (i0 + j));
        }
      if (g.aux) store_box<bf16>(st, t_aux, acc, i0, n0 + 8 * i0, m_base);
#pragma unroll
      for (int j = 0; j < EPI_GROUP; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * (i0 + j) + 2 * h;
          acc[e] = rv[j][h].x + gv[j][h].x * acc[e];
          acc[e + 1] = rv[j][h].y + gv[j][h].y * acc[e + 1];
        }
#pragma unroll
      for (int k = 0; k < EPI_GROUP; k += OUT_NI)
        store_box<TOut>(st, t_out, acc, i0 + k, n0 + 8 * (i0 + k), m_base);
      if (g.aux2) store_box<bf16>(st, t_aux2, acc, i0, n0 + 8 * i0, m_base);
    }
  }
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
// both consumer warpgroups (named barrier 3, 256 threads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// KIND_DGELU, after the epilogue: part[m0 / 128, n0 + c] = the f32 sum of
// du over the tile's 128 rows, in a fixed order: each thread adds its two
// rows (r, r + 8), the 8 row groups of a warp add as a tree (shuffles xor 4,
// 8, 16), the 4 warps of a warpgroup in order through its staging buffers
// (once their stores have been read), then warpgroup 1's 64 rows plus
// warpgroup 2's. gemm.cuh's reduce_rows adds the tiles' rows in order.
template <int BN>
__device__ __forceinline__ void dgelu_column_sums(float (&acc)[BN / 2], const BoxStager& st,
                                                  int wg, int m0, int n0, const GemmArgs& g) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4, t = threadIdx.x % GEMM_WG;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = acc[4 * i + e] + acc[4 * i + 2 + e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[4 * i + e] = v;
    }
  if (st.leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  warpgroup_sync(st.bar);  // the staging buffers are free
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
      st_shared_pair(st.buf + 4 * (warp * BN + 8 * i + 2 * lane), acc[4 * i], acc[4 * i + 1],
                     static_cast<float*>(nullptr));
  }
  warpgroup_sync(st.bar);
  float total[BN / GEMM_WG];
#pragma unroll
  for (int j = 0; j < BN / GEMM_WG; ++j) {
    const uint32_t col = st.buf + 4 * (t + GEMM_WG * j);
    total[j] = ld_shared_f32(col);
#pragma unroll
    for (int w = 1; w < 4; ++w) total[j] += ld_shared_f32(col + 4 * w * BN);
  }
  // warpgroup 2's totals follow its 4 x BN partials in its own buffers
  const uint32_t other = st.buf + (wg == 1 ? 2 * STAGE_BOX : 0) + 4 * 4 * BN;
  if (wg == 2) {
#pragma unroll
    for (int j = 0; j < BN / GEMM_WG; ++j)
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(other + 4 * (t + GEMM_WG * j)),
                   "f"(total[j]) : "memory");
  }
  consumers_sync();
  if (wg == 1) {
    float* part = g.part + long(m0 / GEMM_BM) * g.N + n0;
#pragma unroll
    for (int j = 0; j < BN / GEMM_WG; ++j)
      part[t + GEMM_WG * j] = total[j] + ld_shared_f32(other + 4 * (t + GEMM_WG * j));
  }
  consumers_sync();  // warpgroup 2's totals are read before its buffers take new boxes
}

// LAYOUT is gemm.cuh's LAYOUT_NT, LAYOUT_NN or LAYOUT_TN: ta is A's map
// ((M, K) rows, or (K, M) for TN), tb B's ((N, K) for NT, else (K, N))
template <int LAYOUT, int KIND, int BN, typename TRes, typename TOut>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap t_out,
                 const __grid_constant__ CUtensorMap t_aux,
                 const __grid_constant__ CUtensorMap t_aux2, const GemmArgs g) {
  using R = GemmRing<BN>;
  constexpr bool A_MN = LAYOUT == LAYOUT_TN, B_MN = LAYOUT != LAYOUT_NT;  // MN-major operands
  constexpr uint32_t BOX = 64 * 128;  // an MN-major box: 64 k rows x 128 bytes
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms need 1024 B
  const uint32_t staging = ring + R::STAGES * R::STAGE;       // 2 x 2 boxes
  const uint32_t full = staging + 4 * STAGE_BOX, empty = full + 8 * R::STAGES;
  const int n_tiles = g.N / BN;
  const int tiles = (g.M + GEMM_BM - 1) / GEMM_BM * n_tiles;
  const int k_steps = (g.K + GEMM_BK - 1) / GEMM_BK;
  const int wg = threadIdx.x / GEMM_WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, GEMM_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<GEMM_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;  // ring use, over all of this CTA's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * GEMM_BM, n0 = tile % n_tiles * BN;
        for (int kt = 0; kt < k_steps; ++kt, ++it) {
          const int s = it % R::STAGES, k0 = kt * GEMM_BK;
          if (it >= R::STAGES) mbar_wait(empty + 8 * s, (it / R::STAGES - 1) & 1);
          const uint32_t slot = ring + s * R::STAGE, bar = full + 8 * s;
          mbar_expect_tx(bar, R::STAGE);
          if constexpr (A_MN) {
            tma_load_2d(slot, &ta, bar, m0, k0);
            tma_load_2d(slot + BOX, &ta, bar, m0 + 64, k0);
          } else {
            tma_load_2d(slot, &ta, bar, k0, m0);
          }
          if constexpr (B_MN) {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load_2d(slot + R::A_BYTES + c * BOX, &tb, bar, n0 + 64 * c, k0);
          } else {
            tma_load_2d(slot + R::A_BYTES, &tb, bar, k0, n0);
          }
        }
      }
    }
  } else {  // consumers: rows 64 (wg - 1) .. of each tile
    setmaxnreg_inc<GEMM_CONSUMER_REGS>();
    const int lane = threadIdx.x % 32;
    const uint32_t a_off = (wg - 1) * 64 * GEMM_BK * 2;  // K-major rows or the MN-major box
    constexpr uint32_t hi = desc_hi_bits(1024, 1);  // 8 rows of 128 bytes, 128-byte swizzle
    // a k16 step: 32 bytes along a K-major row, 16 rows of an MN-major box
    constexpr uint32_t A_STEP = A_MN ? 2048 : 32, B_STEP = B_MN ? 2048 : 32;
    constexpr uint32_t A_LBO = A_MN ? BOX : 16, B_LBO = B_MN ? BOX : 16;
    float acc[BN / 2];
    BoxStager st{staging + (wg - 1) * 2 * STAGE_BOX, 0, wg, threadIdx.x % GEMM_WG == 0};
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * GEMM_BM, n0 = tile % n_tiles * BN;
      for (int kt = 0; kt < k_steps; ++kt, ++it) {
        const int s = it % R::STAGES;
        mbar_wait(full + 8 * s, (it / R::STAGES) & 1);
        const uint32_t a = ring + s * R::STAGE + a_off, b = ring + s * R::STAGE + R::A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GEMM_BK / 16; ++kk)
          WgmmaSS<BN, A_MN, B_MN>::run(acc, desc_lo_bits(a + A_STEP * kk, A_LBO),
                                       desc_lo_bits(b + B_STEP * kk, B_LBO), hi,
                                       kt > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's group is done: its slot is free
        if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % R::STAGES));
      }
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % R::STAGES));
      gemm_epilogue<KIND, BN, TRes, TOut>(acc, st, m0 + (wg - 1) * 64, n0, g, &t_out, &t_aux,
                                          &t_aux2);
      if constexpr (KIND == KIND_DGELU) dgelu_column_sums<BN>(acc, st, wg, m0, n0, g);
    }
    if (st.leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// Host side, shared by the launchers of gemm_sm90.cu (NT) and
// gemm_sm90_bwd.cu (NN, TN).

// the tile width, 256 or 128: 128 where N % 256 != 0 or where it ends the
// busiest SM's work more than 1/8 sooner on `sms` SMs (waves of persistent
// CTAs times columns a tile)
inline int tile_n(int M, int N, int sms) {
  if (N % 256) return 128;
  const long m_tiles = (M + GEMM_BM - 1) / GEMM_BM;
  auto span = [&](long bn) { return (m_tiles * (N / bn) + sms - 1) / sms * bn; };
  return 8 * span(128) < 7 * span(256) ? 128 : 256;
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int LAYOUT, int KIND, int BN, typename TRes, typename TOut>
cudaError_t launch_bn(const bf16* A, const bf16* B, const GemmArgs& g, int sms, cudaStream_t s) {
  auto kernel = gemm_sm90_kernel<LAYOUT, KIND, BN, TRes, TOut>;
  constexpr int bytes = GemmRing<BN>::SMEM;
  // the attribute first: the maps' encoder needs the context it makes current
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return err;
  // operands in 64-wide k steps: a K-major one as rows x 64 k, an MN-major
  // one as 64 columns x 64 k rows; outputs in boxes of a consumer's 64 rows
  // (an unused stream gets the output's map, which the kernel never reads)
  CUtensorMap ta, tb, t_out, t_aux, t_aux2;
  if (LAYOUT == LAYOUT_TN) err = matrix_map(&ta, A, g.K, g.M, 64);
  else err = matrix_map(&ta, A, g.M, g.K, GEMM_BM);
  if (err != cudaSuccess) return err;
  if (LAYOUT == LAYOUT_NT) err = matrix_map(&tb, B, g.N, g.K, BN);
  else err = matrix_map(&tb, B, g.K, g.N, 64);
  if (err != cudaSuccess ||
      (err = matrix_map(&t_out, static_cast<const TOut*>(g.out), g.M, g.N, 64)) != cudaSuccess)
    return err;
  t_aux = t_aux2 = t_out;
  if (g.aux && (err = matrix_map(&t_aux, g.aux, g.M, g.N, 64)) != cudaSuccess) return err;
  if (g.aux2 && (err = matrix_map(&t_aux2, g.aux2, g.M, g.N, 64)) != cudaSuccess) return err;
  const int tiles = (g.M + GEMM_BM - 1) / GEMM_BM * (g.N / BN);
  kernel<<<tiles < sms ? tiles : sms, GEMM_THREADS, bytes, s>>>(ta, tb, t_out, t_aux, t_aux2, g);
  return cudaGetLastError();
}

// one instance pair (BN 256 and 128) of the kernel, the width by tile_n
template <int LAYOUT, int KIND, typename TRes, typename TOut>
cudaError_t launch_kind(const bf16* A, const bf16* B, const GemmArgs& g, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (tile_n(g.M, g.N, sms) == 256) return launch_bn<LAYOUT, KIND, 256, TRes, TOut>(A, B, g, sms, s);
  return launch_bn<LAYOUT, KIND, 128, TRes, TOut>(A, B, g, sms, s);
}

}  // namespace sm90
}  // namespace lfm
