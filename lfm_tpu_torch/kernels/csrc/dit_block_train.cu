// K5: the differentiable fused DiT block, the port of
// lfm_tpu/kernels/dit_block_train.py (`make_fused_block_train`). Three C
// entry points, one for each of its pallas_calls, each a short fixed
// sequence of kernels on one stream:
//
// lfm_dit_block_train_fwd (`_block_fwd_call`, `_fwd_kernel`): K2's math and
// rounding points (dit_block.cu), with epilogues that also write the
// residual streams, each rounded to bf16 from the f32 value the forward
// itself goes on with: qkv, ao, pr (the projection before its gate), x1,
// u (the fc1 pre-activation) and h2 (fc2 before its gate). "slim" writes
// only h2, pr and qkv (x1 and u null; ao into scratch).
//
// lfm_dit_block_train_mlp_bwd (`_mlp_bwd_call`, `_mlp_bwd_kernel`):
//   h2b = bf16(LN(x1) (1 + sc_mlp) + sh_mlp)             ln_modulate
//   dg_mlp = sum_t dy h2;  dh2 = dy g_mlp (f32);  db2 = sum dh2 (f32)
//                                                         gate_bwd_kernel
//   du  = (bf16(dh2) W2) gelu'(u);  db1 = sum du (f32);
//   gb  = bf16(gelu(u)), from the same tanh as gelu'(u)   gemm NN, EPI_DGELU
//   dW2 = bf16(dh2)^T gb                                  gemm TN
//   dh  = bf16(du) W1 (f32)                               gemm NN
//   dW1 = bf16(du)^T h2b                                  gemm TN
//   dx1 = bf16(dy + LN_bwd(dh (1 + sc_mlp)))               ln_bwd_rows_kernel
//   dsh_mlp = sum_t dh, dsc_mlp = sum_t dh n2             ln_bwd_cols_kernel
// lfm_dit_block_train_attn_bwd (`_attn_bwd_call`, `_attn_bwd_kernel`):
//   hb  = bf16(LN(x) (1 + sc_msa) + sh_msa)               ln_modulate
//   dg_msa = sum_t dx1 pr;  dpr = dx1 g_msa;  dbproj = sum dpr (f32)
//   do  = bf16(bf16(dpr) Wproj)                           gemm NN
//   dWproj = bf16(dpr)^T ao                               gemm TN
//   dq, dk, dv (bf16) from qkv and do, the probs recomputed per head
//                                                         K3's kernels
//   dbqkv = sum dqkv (f32)                                colsum_rows_kernel
//   dhb = dqkv Wqkv (f32);  dWqkv = dqkv^T hb             gemm NN, TN
//   dx  = bf16(dx1 + LN_bwd(dhb (1 + sc_msa)))            ln_bwd_rows_kernel
//   dsh_msa, dsc_msa                                      ln_bwd_cols_kernel
// LN_bwd(dn) = r (dn - mean(dn) - n mean(dn n)) with n, r recomputed from the
// bf16 stream (E[x^2] - E[x]^2 in f32, eps 1e-6), as `_ln_bwd` does.
// Weights are in torch.nn.Linear layout (out, in), so the weight gradients
// come back in that layout, in f32; dmod is (N, 3, C) f32 in the order
// shift, scale, gate. mod is (N, 6C) bf16.
//
// Sums over rows: the TPU kernels sum each grid cell's rows and add the
// cells in turn into a VMEM accumulator. Here no block carries a sum to
// another: a weight gradient is one TN GEMM whose K runs over all N*T token
// rows; a bias gradient or a modulation cotangent is summed per sample (or
// per 128-row GEMM block) into f32 partials, which a second kernel adds in
// a fixed order. So every result is deterministic.
//
// What bounds it on the H100, at N = 32, T = 256, C = 1024, hidden 4096:
// the forward does 214.7 GFLOP (2 N T C (4C + 2H) + 4 N T^2 C) against about
// 243 MB of inputs and streams; the MLP half 8 N T C H = 274.9 GFLOP; the
// attention half 16 N T C^2 + 10 N T^2 C = 158.9 GFLOP (five T x T products
// per head: logits, dv, dp, dq, dk; ao is a stream, so PV is not redone).
// All three are bound by tensor-core operations (0.217, 0.278 and 0.161 ms
// at 989 TFLOP/s). The forward's four GEMMs are K2's and the MLP half's
// four (NN, TN) run on the same kernel: gemm_sm90.cuh's persistent wgmma +
// TMA kernel, the streams, du and db1's column partials written from its
// register epilogue. The attention half's NN and TN GEMMs are gemm.cuh's
// WMMA tiles (mma.sync), the next to move onto it; the element-wise passes
// and the recomputed LayerNorms round-trip device memory. Fusing those
// passes into the GEMMs is later work.
#include "attention.cuh"
#include "gemm.cuh"

namespace lfm {

constexpr int COL_THREADS = 128;  // columns per block of the per-sample sums

// grid (C / 128, N): column c of sample n over its T rows.
//   dmod3[n, slot_g, c] = sum_t dy * s;  dpre = dy * mod[gate]  (f32)
//   dpre_b = bf16(dpre);  part[n, c] = sum_t dpre
__global__ void __launch_bounds__(COL_THREADS)
gate_bwd_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ s,
                const bf16* __restrict__ mod, int gate_idx, int T, int C,
                bf16* __restrict__ dpre_b, float* __restrict__ dmod3, int slot_g,
                float* __restrict__ part) {
  const int c = blockIdx.x * COL_THREADS + threadIdx.x, n = blockIdx.y;
  const float g = to_f(mod[long(n) * 6 * C + long(gate_idx) * C + c]);
  float dg = 0.0f, db = 0.0f;
  for (int t = 0; t < T; ++t) {
    const long o = (long(n) * T + t) * C + c;
    const float d = to_f(dy[o]);
    dg += d * to_f(s[o]);
    const float dp = d * g;
    db += dp;
    dpre_b[o] = from_f<bf16>(dp);
  }
  dmod3[(long(n) * 3 + slot_g) * C + c] = dg;
  part[long(n) * C + c] = db;
}

// grid (ncols / 128, N): part[n, c] = sum_t f32(a[n*T + t, c])
__global__ void __launch_bounds__(COL_THREADS)
colsum_rows_kernel(const bf16* __restrict__ a, int T, int ncols, float* __restrict__ part) {
  const int c = blockIdx.x * COL_THREADS + threadIdx.x, n = blockIdx.y;
  float acc = 0.0f;
  for (int t = 0; t < T; ++t) acc += to_f(a[(long(n) * T + t) * ncols + c]);
  part[long(n) * ncols + c] = acc;
}

// out[c] = sum_p part[p, c], p = 0 .. P-1 in order
__global__ void reduce_rows_kernel(const float* __restrict__ part, int P, int ncols,
                                   float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncols) return;
  float acc = 0.0f;
  for (int p = 0; p < P; ++p) acc += part[long(p) * ncols + c];
  out[c] = acc;
}

// one block per token row: with n, r of LN(xs) (E[x^2] - E[x]^2, f32),
// dn = dh (1 + mod[scale]), out = bf16(resid + r (dn - mean(dn) - n mean(dn n)));
// stats[row] = (mean, r) for ln_bwd_cols_kernel. Each thread keeps LN_BWD_PER
// values of its row in registers, so C <= LN_BWD_MAX_C.
constexpr int LN_BWD_PER = 16;
constexpr int LN_BWD_MAX_C = LN_BWD_PER * LN_THREADS;
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_rows_kernel(const float* __restrict__ dh, const bf16* __restrict__ xs,
                   const bf16* __restrict__ mod, int scale_idx, const bf16* __restrict__ resid,
                   int T, int C, bf16* __restrict__ out, float* __restrict__ stats) {
  __shared__ float red[LN_THREADS / 32];
  constexpr int PER = LN_BWD_PER;
  const long row = blockIdx.x;
  const bf16* xr = xs + row * C;
  const float* dr = dh + row * C;
  const bf16* m = mod + (row / T) * 6L * C + long(scale_idx) * C;
  float xv[PER], dn[PER];
  float s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * LN_THREADS;
    xv[i] = c < C ? to_f(xr[c]) : 0.0f;
    s += xv[i];
    ss += xv[i] * xv[i];
  }
  const float mu = block_sum(s, red) / C;
  const float var = block_sum(ss, red) / C - mu * mu;
  const float r = rsqrtf(var + kLnEps);
  float sd = 0.0f, sdn = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * LN_THREADS;
    dn[i] = c < C ? dr[c] * (1.0f + to_f(m[c])) : 0.0f;
    xv[i] = (xv[i] - mu) * r;  // n
    sd += dn[i];
    sdn += dn[i] * xv[i];
  }
  const float mean_dn = block_sum(sd, red) / C;
  const float mean_dnn = block_sum(sdn, red) / C;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * LN_THREADS;
    if (c < C)
      out[row * C + c] = from_f<bf16>(to_f(resid[row * C + c]) + r * (dn[i] - mean_dn - xv[i] * mean_dnn));
  }
  if (threadIdx.x == 0) {
    stats[2 * row] = mu;
    stats[2 * row + 1] = r;
  }
}

// grid (C / 128, N): dmod3[n, slot_sh, c] = sum_t dh, dmod3[n, slot_sh + 1, c]
// = sum_t dh n, with n from xs and ln_bwd_rows_kernel's stats
__global__ void __launch_bounds__(COL_THREADS)
ln_bwd_cols_kernel(const float* __restrict__ dh, const bf16* __restrict__ xs,
                   const float* __restrict__ stats, int T, int C, float* __restrict__ dmod3,
                   int slot_sh) {
  const int c = blockIdx.x * COL_THREADS + threadIdx.x, n = blockIdx.y;
  float sh = 0.0f, sc = 0.0f;
  for (int t = 0; t < T; ++t) {
    const long row = long(n) * T + t;
    const float d = dh[row * C + c];
    sh += d;
    sc += d * (to_f(xs[row * C + c]) - stats[2 * row]) * stats[2 * row + 1];
  }
  dmod3[(long(n) * 3 + slot_sh) * C + c] = sh;
  dmod3[(long(n) * 3 + slot_sh + 1) * C + c] = sc;
}

static cudaError_t reduce_rows(const float* part, int P, int ncols, float* out, cudaStream_t s) {
  reduce_rows_kernel<<<(ncols + 255) / 256, 256, 0, s>>>(part, P, ncols, out);
  return cudaGetLastError();
}

}  // namespace lfm

// a refused launch never runs; report the first one
#define LFM_CHECK(call)                                   \
  do {                                                    \
    call;                                                 \
    cudaError_t e_ = cudaGetLastError();                  \
    if (e_ != cudaSuccess) return static_cast<int>(e_);   \
  } while (0)
// a launcher that returns its error (the NT GEMM, the attention)
#define LFM_TRY(call)                                     \
  do {                                                    \
    cudaError_t e_ = (call);                              \
    if (e_ != cudaSuccess) return static_cast<int>(e_);   \
  } while (0)

// x, out: bf16 (N, T, C); mod (N, 6C); weights (out, in) bf16, C % 128 == 0,
// hidden % 128 == 0, C / heads in {56, 64, 72, 80}. Streams (bf16): x1s (N*T,
// C) or null, h2s, prs (N*T, C), qkv (N*T, 3C), ao (N*T, C; scratch when
// slim), us (N*T, hidden) or null. Scratch: h (N*T, C) bf16, x1 (N*T, C)
// f32, g (N*T, hidden) bf16. Seven kernels on `stream`.
extern "C" int lfm_dit_block_train_fwd(const void* x, const void* mod, const void* wqkv,
                                       const void* bqkv, const void* wproj, const void* bproj,
                                       const void* w1, const void* b1, const void* w2,
                                       const void* b2, void* out, void* x1s, void* h2s, void* prs,
                                       void* qkv_buf, void* ao_buf, void* us, void* h_buf,
                                       void* x1_buf, void* g_buf, int N, int T, int C, int hidden,
                                       int heads, void* stream) {
  using lfm::bf16;
  auto s = static_cast<cudaStream_t>(stream);
  auto bp = [](const void* p) { return static_cast<const bf16*>(p); };
  auto mp = [](void* p) { return static_cast<bf16*>(p); };
  const int M = N * T, D = C / heads;
  bf16* h = mp(h_buf);
  bf16* qkv = mp(qkv_buf);
  bf16* ao = mp(ao_buf);
  bf16* g = mp(g_buf);
  float* x1 = static_cast<float*>(x1_buf);
  const bf16* m = bp(mod);

  LFM_CHECK((lfm::ln_modulate_kernel<bf16><<<M, lfm::LN_THREADS, 0, s>>>(bp(x), m, h, T, C, 0, 1)));
  LFM_TRY((lfm::launch_gemm_nt<lfm::EPI_BIAS, bf16, bf16>(h, bp(wqkv), bp(bqkv), qkv, M, 3 * C, C,
                                                          nullptr, nullptr, 0, T, s)));
  LFM_TRY(lfm::launch_attention<true>(qkv, qkv + C, qkv + 2 * C, ao, N, T, heads, D, 3L * C,
                                      3L * C, 3L * C, C, s));
  LFM_TRY((lfm::launch_gemm_nt<lfm::EPI_GATED_AUX, bf16, float>(
      ao, bp(wproj), bp(bproj), x1, M, C, C, bp(x), m, 2, T, s,
      lfm::GemmAux{mp(prs), mp(x1s)})));
  LFM_CHECK((lfm::ln_modulate_kernel<float><<<M, lfm::LN_THREADS, 0, s>>>(x1, m, h, T, C, 3, 4)));
  LFM_TRY((lfm::launch_gemm_nt<lfm::EPI_GELU_AUX, bf16, bf16>(
      h, bp(w1), bp(b1), g, M, hidden, C, nullptr, nullptr, 0, T, s,
      lfm::GemmAux{mp(us), nullptr})));
  LFM_TRY((lfm::launch_gemm_nt<lfm::EPI_GATED_AUX, float, bf16>(
      g, bp(w2), bp(b2), mp(out), M, C, hidden, x1, m, 5, T, s,
      lfm::GemmAux{mp(h2s), nullptr})));
  return 0;
}

// Inputs bf16: x1, h2, dy (N*T, C), u (N*T, hidden), mod (N, 6C), w1
// (hidden, C), w2 (C, hidden). Outputs: dx1 bf16 (N*T, C); dmod3 f32 (N, 3,
// C); dw1 f32 (hidden, C), db1 (hidden), dw2 (C, hidden), db2 (C). Scratch:
// h2b, dh2b (N*T, C) bf16; gb, du (N*T, hidden) bf16; dh (N*T, C) f32;
// stats (N*T, 2) f32; part f32 of max(N*C, ceil(N*T/128)*hidden).
// (N*T) % 32 == 0, C <= 4096. Ten kernels on `stream`.
extern "C" int lfm_dit_block_train_mlp_bwd(const void* x1, const void* mod, const void* h2,
                                           const void* u, const void* w1, const void* w2,
                                           const void* dy, void* dx1, void* dmod3, void* dw1,
                                           void* db1, void* dw2, void* db2, void* h2b_buf,
                                           void* dh2b_buf, void* gb_buf, void* du_buf,
                                           void* dh_buf, void* stats_buf, void* part_buf, int N,
                                           int T, int C, int hidden, void* stream) {
  using lfm::bf16;
  if (C > lfm::LN_BWD_MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto bp = [](const void* p) { return static_cast<const bf16*>(p); };
  auto mp = [](void* p) { return static_cast<bf16*>(p); };
  auto fp = [](void* p) { return static_cast<float*>(p); };
  const int M = N * T;
  const bf16* m = bp(mod);
  bf16* h2b = mp(h2b_buf);
  bf16* dh2b = mp(dh2b_buf);
  bf16* gb = mp(gb_buf);
  bf16* du = mp(du_buf);
  float* dh = fp(dh_buf);
  float* part = fp(part_buf);
  const dim3 cols(C / lfm::COL_THREADS, N);

  LFM_CHECK((lfm::ln_modulate_kernel<bf16><<<M, lfm::LN_THREADS, 0, s>>>(bp(x1), m, h2b, T, C, 3, 4)));
  LFM_CHECK((lfm::gate_bwd_kernel<<<cols, lfm::COL_THREADS, 0, s>>>(bp(dy), bp(h2), m, 5, T, C, dh2b,
                                                                     fp(dmod3), 2, part)));
  LFM_CHECK((lfm::reduce_rows(part, N, C, fp(db2), s)));
  LFM_TRY(lfm::launch_gemm_bwd(lfm::LAYOUT_NN, lfm::EPI_DGELU, dh2b, bp(w2), du, false, bp(u),
                               part, gb, M, hidden, C, s));
  LFM_CHECK((lfm::reduce_rows(part, (M + lfm::GM - 1) / lfm::GM, hidden, fp(db1), s)));
  LFM_TRY(lfm::launch_gemm_bwd(lfm::LAYOUT_TN, lfm::EPI_STORE, dh2b, gb, dw2, true, nullptr,
                               nullptr, nullptr, C, hidden, M, s));
  LFM_TRY(lfm::launch_gemm_bwd(lfm::LAYOUT_NN, lfm::EPI_STORE, du, bp(w1), dh, true, nullptr,
                               nullptr, nullptr, M, C, hidden, s));
  LFM_TRY(lfm::launch_gemm_bwd(lfm::LAYOUT_TN, lfm::EPI_STORE, du, h2b, dw1, true, nullptr,
                               nullptr, nullptr, hidden, C, M, s));
  LFM_CHECK((lfm::ln_bwd_rows_kernel<<<M, lfm::LN_THREADS, 0, s>>>(dh, bp(x1), m, 4, bp(dy), T, C,
                                                                   mp(dx1), fp(stats_buf))));
  LFM_CHECK((lfm::ln_bwd_cols_kernel<<<cols, lfm::COL_THREADS, 0, s>>>(dh, bp(x1), fp(stats_buf), T,
                                                                       C, fp(dmod3), 0)));
  return 0;
}

// Inputs bf16: x, pr, ao, dx1 (N*T, C), qkv (N*T, 3C), mod (N, 6C), wqkv
// (3C, C), wproj (C, C). Outputs: dx bf16 (N*T, C); dmod3 f32 (N, 3, C);
// dwqkv f32 (3C, C), dbqkv (3C), dwproj (C, C), dbproj (C). Scratch: hb,
// dpr_b, dao (N*T, C) bf16; dqkv (N*T, 3C) bf16; dhb (N*T, C) f32; stats
// (N*T, 2) f32; astats f32, 3 * N * heads * Tp (Tp = T rounded up to 64; K3's
// row statistics); part f32 of N*3C.
// (N*T) % 32 == 0, C <= 4096. Eleven kernels on `stream` (K3's two among them).
extern "C" int lfm_dit_block_train_attn_bwd(const void* x, const void* mod, const void* pr,
                                            const void* qkv, const void* ao, const void* wqkv,
                                            const void* wproj, const void* dx1, void* dx,
                                            void* dmod3, void* dwqkv, void* dbqkv, void* dwproj,
                                            void* dbproj, void* hb_buf, void* dpr_buf,
                                            void* dao_buf, void* dqkv_buf, void* dhb_buf,
                                            void* stats_buf, void* astats_buf, void* part_buf,
                                            int N, int T, int C, int heads, void* stream) {
  using lfm::bf16;
  if (C > lfm::LN_BWD_MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto bp = [](const void* p) { return static_cast<const bf16*>(p); };
  auto mp = [](void* p) { return static_cast<bf16*>(p); };
  auto fp = [](void* p) { return static_cast<float*>(p); };
  const int M = N * T, D = C / heads;
  const bf16* m = bp(mod);
  bf16* hb = mp(hb_buf);
  bf16* dpr = mp(dpr_buf);
  bf16* dao = mp(dao_buf);
  bf16* dqkv = mp(dqkv_buf);
  float* dhb = fp(dhb_buf);
  float* part = fp(part_buf);
  const dim3 cols(C / lfm::COL_THREADS, N);

  LFM_CHECK((lfm::ln_modulate_kernel<bf16><<<M, lfm::LN_THREADS, 0, s>>>(bp(x), m, hb, T, C, 0, 1)));
  LFM_CHECK((lfm::gate_bwd_kernel<<<cols, lfm::COL_THREADS, 0, s>>>(bp(dx1), bp(pr), m, 2, T, C, dpr,
                                                                     fp(dmod3), 2, part)));
  LFM_CHECK((lfm::reduce_rows(part, N, C, fp(dbproj), s)));
  LFM_CHECK((lfm::launch_gemm<bf16, lfm::LAYOUT_NN>(dpr, bp(wproj), dao, M, C, C, s)));
  LFM_CHECK((lfm::launch_gemm<float, lfm::LAYOUT_TN>(dpr, bp(ao), fp(dwproj), C, C, M, s)));
  const bf16* q = bp(qkv);
  cudaError_t err = lfm::launch_attn_bwd_sm90(q, q + C, q + 2 * C, dao, dqkv, dqkv + C,
                                              dqkv + 2 * C, fp(astats_buf), N, T, heads, D,
                                              3L * C, 3L * C, 3L * C, C, 3L * C, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  LFM_CHECK((lfm::colsum_rows_kernel<<<dim3(3 * C / lfm::COL_THREADS, N), lfm::COL_THREADS, 0, s>>>(
      dqkv, T, 3 * C, part)));
  LFM_CHECK((lfm::reduce_rows(part, N, 3 * C, fp(dbqkv), s)));
  LFM_CHECK((lfm::launch_gemm<float, lfm::LAYOUT_NN>(dqkv, bp(wqkv), dhb, M, C, 3 * C, s)));
  LFM_CHECK((lfm::launch_gemm<float, lfm::LAYOUT_TN>(dqkv, hb, fp(dwqkv), 3 * C, C, M, s)));
  LFM_CHECK((lfm::ln_bwd_rows_kernel<<<M, lfm::LN_THREADS, 0, s>>>(dhb, bp(x), m, 1, bp(dx1), T, C,
                                                                   mp(dx), fp(stats_buf))));
  LFM_CHECK((lfm::ln_bwd_cols_kernel<<<cols, lfm::COL_THREADS, 0, s>>>(dhb, bp(x), fp(stats_buf), T,
                                                                       C, fp(dmod3), 0)));
  return 0;
}
#undef LFM_CHECK
