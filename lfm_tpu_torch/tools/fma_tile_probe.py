"""Measures the f32 FMA rate an H100 SM reaches in the register-blocked
products of f32 K3 at D = 128/256 (csrc/attention_bwd_wide_f32.cu), tile by
tile, with the operands already in shared memory: the ceiling each tile
shape and loop form sets on the kernel's phases.

    python -m lfm_tpu_torch.tools.fma_tile_probe

One CTA of 256 threads an SM, 132 CTAs; each thread runs its tile's
product over the same shared-memory operands (shifted by 4 floats every
other iteration, so that no load leaves the loop) ITERS times, timed with
clock64(). Cases: the score products A B^T (the kernel's ``nt_split``
element by element, ``nt``, and by component, ``nt_cm``), by tile (RM x
RN), slices of D (S) and row groups (RGN), and the output products
(``nn``: ``nn_rows`` 8 x 4, ``nn_rows8`` 8 x 8). Prints
one JSON line: each case's FMA a cycle an SM (the card's peak is 128) and
the card's name, power limit and SM clock. Builds its source with nvcc
into kernels/_build/fma_tile_probe/ (ignored by git), including the
kernel source for its functions. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import subprocess

from lfm_tpu_torch.kernels._build import ARCH, BUILD_ROOT, CSRC, find_nvcc

ITERS = 256
# (name, form, D, S, RM, RN, RGN): nt cases take Tile<S, RGN, 256>
NT_CASES = (
    ("4x4 S1 D128", 128, 1, 4, 4, 16),
    ("4x8 S2 D128", 128, 2, 4, 8, 16),
    ("8x4 S2 D128", 128, 2, 8, 4, 8),
    ("8x8 S2 D128", 128, 2, 8, 8, 8),
    ("4x2 S4 D256", 256, 4, 4, 2, 4),
    ("8x4 S4 D256", 256, 4, 8, 4, 4),
    ("8x8 S4 D256", 256, 4, 8, 8, 4),
)

SOURCE = r"""
#include <cstdio>
#include "attention_bwd_wide_f32.cu"
using namespace lfm::wide32;

template <int D, int S, int RM, int RN, int RGN, bool CM>
__global__ void __launch_bounds__(256, 1) nt_probe(float* out, long long* cycles, int iters) {
  extern __shared__ __align__(16) float sm[];
  constexpr int LD = D + 4 * S;
  using TL = Tile<S, RGN, 256>;
  constexpr int KGN = TL::KGN, AR = RGN * RM, BR = KGN * RN;
  for (int i = threadIdx.x; i < (AR + BR) * LD + 8; i += 256) sm[i] = float(i % 7) * 0.01f;
  __syncthreads();
  int rg, kg, sl;
  TL::at(threadIdx.x, rg, kg, sl);
  float acc[RM][RN] = {};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const float* A = sm + 4 * (it & 1);
    const float* B = sm + AR * LD + 4 * (it & 1);
    nt_split<D, LD, LD, S, RM, RN, RGN, KGN, CM>(acc, A, rg, B, kg, sl);
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) s += acc[i][j];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

// the dk/dv products: 8 key rows x 4 or 8 columns over 32 queries, A of
// row stride 36 (p / ds), B of row stride D + 4 S; 128 threads a product
template <int D, int S, int WIDE>
__global__ void __launch_bounds__(256, 1) nn_probe(float* out, long long* cycles, int iters) {
  extern __shared__ __align__(16) float sm[];
  constexpr int LD = D + 4 * S, BK = D == 128 ? 64 : 32, LDP = 36;
  constexpr int CG = WIDE ? D / 8 : D / 4, NT = WIDE ? 128 : 256, RS = NT / CG, RMO = BK / RS;
  for (int i = threadIdx.x; i < BK * LDP + 32 * LD + 8; i += 256) sm[i] = float(i % 7) * 0.01f;
  __syncthreads();
  const int t = threadIdx.x % NT, cg = t % CG, oy = t / CG;
  float acc[RMO][WIDE ? 8 : 4] = {};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const float* A = sm + 4 * (it & 1);
    const float* B = sm + BK * LDP + 4 * (it & 1);
    if constexpr (WIDE) nn_rows8<RMO, RS, LD, D / 2>(acc, A, LDP, oy, B, 4 * cg, 32);
    else nn_rows<RMO, RS, LD>(acc, A, LDP, oy, B, 4 * cg, 32);
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  float s = 0.0f;
  for (int i = 0; i < RMO; ++i)
    for (int j = 0; j < (WIDE ? 8 : 4); ++j) s += acc[i][j];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

template <class K>
double run(K kernel, int smem, double fma_per_thread_iter, float* out, long long* cycles,
           int iters) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<132, 256, smem>>>(out, cycles, iters);
  if (cudaDeviceSynchronize() != cudaSuccess) return -1.0;
  long long h[132];
  cudaMemcpy(h, cycles, sizeof(h), cudaMemcpyDeviceToHost);
  double sum = 0;
  for (int b = 0; b < 132; ++b) sum += double(h[b]);
  return fma_per_thread_iter * 256.0 * iters / (sum / 132);
}

template <int D, int S, int RM, int RN, int RGN>
void nt_case(const char* name, float* out, long long* cycles, int iters) {
  constexpr int LD = D + 4 * S, KGN = Tile<S, RGN, 256>::KGN;
  const int smem = 4 * ((RGN * RM + KGN * RN) * LD + 8);
  const double fma = double(RM) * RN * D / S;
  const double a = run(nt_probe<D, S, RM, RN, RGN, false>, smem, fma, out, cycles, iters);
  const double b = run(nt_probe<D, S, RM, RN, RGN, true>, smem, fma, out, cycles, iters);
  printf("%s|nt|%.3f\n%s|nt_cm|%.3f\n", name, a, name, b);
}

template <int D, int S, int WIDE>
void nn_case(const char* name, float* out, long long* cycles, int iters) {
  constexpr int LD = D + 4 * S, BK = D == 128 ? 64 : 32;
  const int smem = 4 * (BK * 36 + 32 * LD + 8);
  const double fma = double(BK) * D * 32 / (WIDE ? 128 : 256);
  printf("%s|nn|%.3f\n", name, run(nn_probe<D, S, WIDE>, smem, fma, out, cycles, iters));
}

int main() {
  float* out;
  long long* cycles;
  cudaMalloc(&out, 132 * 256 * sizeof(float));
  cudaMalloc(&cycles, 132 * sizeof(long long));
%CASES%
  nn_case<128, 2, 0>("8x4 D128", out, cycles, %ITERS%);
  nn_case<128, 2, 1>("8x8 D128", out, cycles, %ITERS%);
  nn_case<256, 4, 0>("8x4 D256", out, cycles, %ITERS%);
  nn_case<256, 4, 1>("8x8 D256", out, cycles, %ITERS%);
  return 0;
}
"""


def main() -> int:
    cases = "\n".join(f'  nt_case<{d}, {s}, {rm}, {rn}, {rgn}>("{name}", out, cycles, {ITERS});'
                      for name, d, s, rm, rn, rgn in NT_CASES)
    src = SOURCE.replace("%CASES%", cases).replace("%ITERS%", str(ITERS))
    out_dir = BUILD_ROOT / "fma_tile_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, exe = out_dir / "probe.cu", out_dir / "probe"
    cu.write_text(src)
    subprocess.run([find_nvcc(), *ARCH, "-std=c++17", "-O3", "-I", str(CSRC), str(cu), "-o",
                    str(exe)], check=True, timeout=600)
    res = subprocess.run([str(exe)], capture_output=True, text=True, timeout=300, check=True)
    rows = {}
    for line in res.stdout.splitlines():
        name, form, rate = line.split("|")
        rows[f"{form} {name}"] = float(rate)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True)
    print(json.dumps({"card": smi.stdout.strip(), "iters": ITERS,
                      "fma_per_sm_cycle": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
