"""Measures what a 16-byte shared-memory load (LDS.128) costs an H100 SM, by
the addresses a warp's lanes read: the number that sets the register tiles
of the f32 FMA attention kernels (csrc/attention_long_f32.cuh).

    python -m lfm_tpu_torch.tools.smem_probe

One CTA of 8 warps an SM, 132 CTAs; each thread issues 8 independent float4
loads an iteration (4096 iterations, addresses fixed per lane, offsets that
keep the banks) into independent sums, timed with clock64(). Prints one
JSON line: for each address pattern, the SM's cycles per warp load, and
the card's name and power limit. Builds its CUDA source with nvcc into
kernels/_build/smem_probe/ (ignored by git). Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

from lfm_tpu_torch.kernels._build import ARCH, BUILD_ROOT, find_nvcc

# (name, lane -> float4 index); rows are 17 float4 (68 floats) apart, as
# the kernels' tiles padded by 16 bytes, so distinct rows hit distinct banks
PATTERNS = (
    ("32 addresses a warp", "lane"),
    ("1 a quarter-warp, 4 a warp", "(lane / 8) * 17"),
    ("1 a warp", "0"),
    ("2 a quarter-warp, 8 a warp", "(lane / 4) * 17"),
    ("2 a quarter-warp, the same 2 in each", "(lane % 2) * 17"),
    ("4 a quarter-warp, the same 4 in each", "(lane % 4) * 17"),
    ("8 a quarter-warp, the same 8 in each", "(lane % 8) * 17"),
)

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>
__global__ void probe(float* out, long long* cycles, int iters, int mode) {
  __shared__ float4 buf[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  int idx = 0;
  switch (mode) {
%CASES%
  }
  idx += (threadIdx.x / 32) * 64;
  float4 acc[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) acc[u] = make_float4(0, 0, 0, 0);
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const int o = (it & 3) * 272;  // 1088 floats: the same banks
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float4 v = buf[(idx + o + u * 8) & 2047];
      acc[u].x += v.x; acc[u].y += v.y; acc[u].z += v.z; acc[u].w += v.w;
    }
  }
  const long long t1 = clock64();
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  float sum = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) sum += acc[u].x + acc[u].y + acc[u].z + acc[u].w;
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}
int main() {
  const int blocks = 132, threads = 256, iters = 4096;
  float* out; long long* cycles;
  cudaMalloc(&out, blocks * threads * sizeof(float));
  cudaMalloc(&cycles, blocks * sizeof(long long));
  for (int mode = 0; mode < %COUNT%; ++mode) {
    probe<<<blocks, threads>>>(out, cycles, iters, mode);
    if (cudaDeviceSynchronize() != cudaSuccess) return 1;
    long long h[132];
    cudaMemcpy(h, cycles, sizeof(h), cudaMemcpyDeviceToHost);
    long long sum = 0;
    for (int b = 0; b < blocks; ++b) sum += h[b];
    // 8 warps x 8 loads an iteration share the SM
    printf("%.4f\n", double(sum) / blocks / (iters * 8.0 * threads / 32));
  }
  return 0;
}
"""


def main() -> int:
    cases = "\n".join(f"    case {i}: idx = {expr}; break;" for i, (_, expr) in enumerate(PATTERNS))
    src = SOURCE.replace("%CASES%", cases).replace("%COUNT%", str(len(PATTERNS)))
    out_dir = BUILD_ROOT / "smem_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, exe = out_dir / "probe.cu", out_dir / "probe"
    cu.write_text(src)
    subprocess.run([find_nvcc(), *ARCH, "-O3", str(cu), "-o", str(exe)], check=True, timeout=300)
    res = subprocess.run([str(exe)], capture_output=True, text=True, timeout=300, check=True)
    per_load = [float(x) for x in res.stdout.split()]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(json.dumps({"card": smi.stdout.strip(), "source": str(Path(cu).name),
                      "sm_cycles_per_warp_lds128": {name: c for (name, _), c in
                                                    zip(PATTERNS, per_load)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
