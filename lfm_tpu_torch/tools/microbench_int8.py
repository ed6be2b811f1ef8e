"""P1's probe on the card: the int8 MLP chain against the bf16 one.

    python -m lfm_tpu_torch.tools.microbench_int8

The port of tools/microbench_int8_pallas.py at its own shapes: x (GRID *
ROWS, D) = (16384, 1024) bf16 from a seed, int8 weights W1 (H, D) and W2
(D, H) drawn in [-127, 127) with scales 1e-4, and their bf16 counterparts
(W * 1e-4). One call chains CHAIN = 8 steps, each ``int8_mlp`` (quantize ->
int8 product -> dequant -> GELU -> quantize -> int8 product -> dequant, no
bias) for the int8 side and ``bf16_mlp`` for the bf16 side, with the
output rounded to bf16 as the Pallas kernels write it. Each call is timed
with CUDA events, the best of REPS after one warm-up, as the JAX tool
takes the best of its REPS. Prints ms and TOP/s of each side and their
ratio, the card's name beside them; it reports what the card does and
decides nothing. Needs a CUDA card.
"""

from __future__ import annotations

import json
from typing import Dict

import torch

ROWS, D, H = 1024, 1024, 4096
GRID = 16  # the JAX tool's grid cells: 16 x 1024 rows in one call
CHAIN = 8
REPS = 5
SCALE = 1e-4


def probe_inputs(device, seed: int = 0):
    """x bf16 (GRID * ROWS, D); int8 W1 (H, D), W2 (D, H) in Linear layout
    with (out,) f32 scales; the bf16 weights W * SCALE."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn(GRID * ROWS, D, generator=gen, device=device).bfloat16()
    w1 = torch.randint(-127, 127, (H, D), generator=gen, device=device, dtype=torch.int8)
    w2 = torch.randint(-127, 127, (D, H), generator=gen, device=device, dtype=torch.int8)
    s1 = torch.full((H,), SCALE, device=device)
    s2 = torch.full((D,), SCALE, device=device)
    w1b = (w1.float() * SCALE).bfloat16()
    w2b = (w2.float() * SCALE).bfloat16()
    return dict(x=x, w1=w1, s1=s1, w2=w2, s2=s2, w1b=w1b, w2b=w2b)


def run_int8(inp, mlp=None) -> torch.Tensor:
    """One probe call: CHAIN steps of ``mlp`` (``int8_mlp`` by default),
    bf16 out."""
    from lfm_tpu_torch.kernels.int8_matmul import int8_mlp

    mlp = mlp or int8_mlp
    xf = inp["x"]
    for _ in range(CHAIN):
        xf = mlp(xf, inp["w1"], inp["s1"], None, inp["w2"], inp["s2"], None)
    return xf.bfloat16()


def run_bf16(inp, mlp=None) -> torch.Tensor:
    """One probe call: CHAIN steps of ``mlp`` (``bf16_mlp`` by default)."""
    from lfm_tpu_torch.kernels.int8_matmul import bf16_mlp

    mlp = mlp or bf16_mlp
    xt = inp["x"]
    for _ in range(CHAIN):
        xt = mlp(xt, inp["w1b"], inp["w2b"])
    return xt


def time_call(fn, reps: int = REPS) -> float:
    """Best of ``reps`` CUDA-event timings of ``fn()`` after one warm-up, ms."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def measure(device="cuda", reps: int = REPS) -> Dict[str, float]:
    """The probe's line: ms and TOP/s of the bf16 and int8 chains."""
    inp = probe_inputs(torch.device(device))
    ops = CHAIN * GRID * 2 * (2 * ROWS * D * H)
    tb = time_call(lambda: run_bf16(inp), reps)
    ti = time_call(lambda: run_int8(inp), reps)
    return {"probe": "microbench_int8", "rows": GRID * ROWS, "d": D, "h": H, "chain": CHAIN,
            "ops": ops, "bf16_ms": tb, "bf16_tflops": ops / (tb * 1e-3) / 1e12,
            "int8_ms": ti, "int8_tops": ops / (ti * 1e-3) / 1e12, "speedup": tb / ti,
            "device": torch.cuda.get_device_name(torch.device(device))}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("microbench_int8 needs a CUDA card")
    res = measure()
    print(f"bf16 mlp chain : {res['bf16_ms']:8.3f} ms  {res['bf16_tflops']:7.1f} TFLOP/s")
    print(f"int8 mlp chain : {res['int8_ms']:8.3f} ms  {res['int8_tops']:7.1f} TOP/s")
    print(f"speedup: {res['speedup']:.2f}x on {res['device']}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
