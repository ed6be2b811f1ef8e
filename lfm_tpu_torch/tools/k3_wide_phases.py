"""A clock64() phase profile of f32 K3 at the origin ADM's D = 128/256
(csrc/attention_bwd_wide_f32.cu), in place of ``ncu``, which the card's
machine lacks.

    python -m lfm_tpu_torch.tools.k3_wide_phases [N,T,H,D ...]

Compiles that source alone with ``-DLFM_K3_PHASES`` and a small C entry
into kernels/_build/k3_wide_phases/ (ignored by git). With the macro, thread
0 of the CTA at the middle of each kernel's grid stamps clock64() at the
kernel's phase boundaries and sums the cycles it waits for its loads; the
normal build compiles none of it. Runs each shape (default: the five of
``bench_attention --wide-bwd``) once to warm up and once to read, on
contiguous seeded inputs, and prints one JSON line: for each shape and
kernel the cycles of each phase (differences of the stamps) and of the
waits, with the card's name, power limit and SM clock. Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from lfm_tpu_torch.kernels._build import ARCH, BUILD_ROOT, CSRC, find_nvcc

SHAPES = ((112, 16, 4, 128), (24, 64, 4, 128), (24, 16, 4, 256), (16, 256, 4, 128),
          (16, 1024, 4, 256))
# the stamps of each kernel, in the order they are taken (slot 15: waits)
PHASES = {
    0: ("start", "loaded", "scores", "row passes", "dq", "dk dv"),
    1: ("start", "s", "row pass", "dp", "delta ds", "dq", "store"),
    2: ("start", "chunks", "store"),
}
NAMES = {0: "attn_wide_bwd_short_kernel", 1: "attn_wide_bwd_dq_kernel",
         2: "attn_wide_bwd_dkdv_kernel"}

SHIM = r"""
#define LFM_K3_PHASES
#include "attention_bwd_wide_f32.cu"
extern "C" int k3_phases_run(const void* q, const void* k, const void* v, const void* dout,
                             void* dq, void* dk, void* dv, void* stats, int N, int T, int H,
                             int D, long long* out) {
  long long zero[48] = {};
  cudaMemcpyToSymbol(lfm::wide32::k3_phase_clock, zero, sizeof(zero));
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  const long ld = long(H) * D;
  cudaError_t err = lfm::launch_attn_bwd_wide_f32(c(q), c(k), c(v), c(dout), m(dq), m(dk),
                                                  m(dv), m(stats), N, T, H, D, ld, ld, ld, ld,
                                                  3 * ld, 0);
  if (err != cudaSuccess) return int(err);
  if ((err = cudaDeviceSynchronize()) != cudaSuccess) return int(err);
  return int(cudaMemcpyFromSymbol(out, lfm::wide32::k3_phase_clock, sizeof(zero)));
}
"""


def build() -> ctypes.CDLL:
    out = BUILD_ROOT / "k3_wide_phases"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "shim.cu", out / "libk3_wide_phases.so"
    src.write_text(SHIM)
    subprocess.run([find_nvcc(), *ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(CSRC), str(src), "-o", str(lib)], check=True, timeout=600)
    dll = ctypes.CDLL(str(lib))
    dll.k3_phases_run.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return dll


def profile(dll, shape):
    n, t, h, d = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(sum(shape))
    q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda") for _ in range(4))
    g = torch.empty((n, t, 3, h, d), device="cuda")
    stats = torch.empty((3 * n * h * (-(-t // 64) * 64),), device="cuda")
    clocks = (ctypes.c_longlong * 48)()
    for _ in range(2):
        rc = dll.k3_phases_run(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                               g[:, :, 0].data_ptr(), g[:, :, 1].data_ptr(),
                               g[:, :, 2].data_ptr(), stats.data_ptr(), n, t, h, d, clocks)
        if rc:
            raise RuntimeError(f"k3_phases_run {shape}: CUDA error {rc}")
    rows = {}
    for kern, names in PHASES.items():
        stamps = list(clocks[16 * kern:16 * kern + len(names)])
        if not any(stamps):
            continue  # a kernel this shape does not launch
        rows[NAMES[kern]] = {
            "phases": {names[i]: stamps[i] - stamps[i - 1] for i in range(1, len(names))},
            "total": stamps[-1] - stamps[0], "waits": clocks[16 * kern + 15]}
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k3_wide_phases needs a CUDA card")
    shapes = [tuple(int(x) for x in a.split(",")) for a in sys.argv[1:]] or SHAPES
    dll = build()
    rows = [{"shape": list(s), "kernels": profile(dll, s)} for s in shapes]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True)
    print(json.dumps({"card": smi.stdout.strip(), "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
