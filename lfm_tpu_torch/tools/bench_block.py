"""Times the port's K2 (``fused_dit_block``) and K5 forward
(``block_train_fwd``) on the card, and each of their NT GEMMs alone, with
each block's error against its plain version.

    python -m lfm_tpu_torch.tools.bench_block [--timing-only]

or, to time another checkout's kernels on the same inputs (its package is
the one imported; its kernels are built in that checkout):

    PYTHONPATH=<other checkout> python <this checkout>/lfm_tpu_torch/tools/bench_block.py

Shapes: DiT-L/2's block (T = 256, C = 1024, hidden 4096, 16 heads); K2 at
N = 200 (the sampling batch) and 8, K5's forward with full and slim
streams at N = 32 (the train batch) and 8. Inputs come from a CUDA
generator seeded per case, so two checkouts see the same values. Each
block is timed with CUDA events, the mean of REPS calls after WARMUP,
REPEATS times, and by ``torch.profiler`` as the device time of REPS calls
over REPS, in all and by kernel (``device_kernels_ms``: each GEMM, the
attention and the LayerNorms of the block apart); beside it the max abs
error of each output against the plain version, the error relative to
max |plain| (for out and x1, to max |plain - x|, the block's update), and
a digest of the outputs' bytes (two checkouts that give the same bits give
the same digest). Where the checkout has the GEMM's own wrapper
(``kernels/gemm.py``), each of the blocks' GEMMs is also timed alone at
K2's N = 200 and K5's N = 32 (``gemm_rows``, which ``chip_smoke.py``'s
``gemm_redesign`` line reuses): ms, TFLOP/s, share of its bound, and
``torch.matmul`` of the same bf16 product.
``--timing-only`` skips the plain versions and the profiler (the repeated
runs of an A/B comparison). Prints one JSON line with the card's name and
power limit and the file of the package that ran. Needs a CUDA card.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys

import torch

T, C, HID, HEADS = 256, 1024, 4096, 16
K2_BATCHES = (200, 8)
K5_CASES = ((32, "full"), (32, "slim"), (8, "full"), (8, "slim"))
WARMUP, REPS, REPEATS = 3, 20, 3
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12  # H100 SXM data sheet


def time_ms(fn, reps: int = REPS) -> float:
    for _ in range(WARMUP):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn):
    """Device time of one call, in all and by kernel (the kernels' own rows
    of torch.profiler's trace of REPS calls, over REPS)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    by_kernel = {e.key[:90]: e.self_device_time_total / REPS / 1e3
                 for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    return {"device_ms": sum(by_kernel.values()), "device_kernels_ms": by_kernel}


def digest(*tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def generator(seed: int) -> torch.Generator:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return gen


def block_inputs(n: int, gen: torch.Generator):
    """A DiT-L/2 block's inputs for a batch of n, every weight non-zero (the
    scales of chip_smoke.py's)."""
    def rn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).bfloat16()

    return dict(x=rn(n, T, C), mod=rn(n, 6 * C, scale=0.3),
                wqkv=rn(3 * C, C, scale=C ** -0.5), bqkv=rn(3 * C, scale=0.02),
                wproj=rn(C, C, scale=C ** -0.5), bproj=rn(C, scale=0.02),
                w1=rn(HID, C, scale=C ** -0.5), b1=rn(HID, scale=0.02),
                w2=rn(C, HID, scale=HID ** -0.5), b2=rn(C, scale=0.02))


def errors(names, got, want, x):
    """{name: (max abs error, relative error)}; out and x1 relative to the
    block's update max |plain - x|, the others to max |plain|."""
    errs = {}
    for name, g, w in zip(names, got, want):
        err = float((g.float() - w.float()).abs().max())
        ref = (w.float() - x.float()) if name in ("out", "x1") else w.float()
        errs[name] = (err, err / float(ref.abs().max()))
    return errs


def bench_k2(n: int, timing_only: bool):
    from lfm_tpu_torch.kernels.dit_block import fused_dit_block, reference_block

    blk = block_inputs(n, generator(2000 + n))
    run = lambda: fused_dit_block(**blk, num_heads=HEADS)  # noqa: E731
    row = {"kernel": "fused_dit_block", "shape": [n, T, C, HID, HEADS],
           "ms": [time_ms(run) for _ in range(REPEATS)]}
    if not timing_only:
        out = run()
        errs = errors(("out",), (out,), (reference_block(**blk, num_heads=HEADS),), blk["x"])
        row.update(max_abs_err=errs["out"][0], rel_err=errs["out"][1], digest=digest(out),
                   **device_ms(run))
    return row


def bench_k5(n: int, mode: str, timing_only: bool):
    from lfm_tpu_torch.kernels.dit_block_train import (block_train_fwd,
                                                       reference_block_fwd_streams)

    blk = block_inputs(n, generator(5000 + n))
    run = lambda: block_train_fwd(**blk, num_heads=HEADS, save_streams=mode)  # noqa: E731
    row = {"kernel": "dit_block_train_fwd", "streams": mode, "shape": [n, T, C, HID, HEADS],
           "ms": [time_ms(run) for _ in range(REPEATS)]}
    if not timing_only:
        got = run()
        want = reference_block_fwd_streams(**blk, num_heads=HEADS, save_streams=mode)
        names = (("out", "x1", "h2", "pr", "qkv", "ao", "u") if mode == "full"
                 else ("out", "h2", "pr", "qkv"))
        errs = errors(names, got, want, blk["x"])
        row.update(max_abs_err={k: e[0] for k, e in errs.items()},
                   rel_err={k: e[1] for k, e in errs.items()}, digest=digest(*got),
                   **device_ms(run))
    return row


def gemm_cases(n: int, streams: bool):
    """The four NT GEMMs of K2's block (streams False) or K5's forward at a
    batch of n: (name, M, K, N, epilogue, resid dtype or None, aux, aux2)."""
    m, bf, f32 = n * T, torch.bfloat16, torch.float32
    if streams:
        return (("qkv", m, C, 3 * C, "bias", None, False, False),
                ("proj", m, C, C, "gated_aux", bf, True, True),
                ("fc1", m, C, HID, "gelu_aux", None, True, False),
                ("fc2", m, HID, C, "gated_aux", f32, True, False))
    return (("qkv", m, C, 3 * C, "bias", None, False, False),
            ("proj", m, C, C, "gated", bf, False, False),
            ("fc1", m, C, HID, "gelu", None, False, False),
            ("fc2", m, HID, C, "gated", f32, False, False))


def gemm_rows(n: int, streams: bool, reps: int = REPS):
    """Each GEMM of K2 (or K5's forward) at batch n alone through
    ``kernels.gemm.gemm`` on seeded inputs: ms, TFLOP/s, its bound (the
    larger of bytes / 3.35 TB/s and 2 M N K / 989 TFLOP/s) and share,
    and ``torch.matmul`` of the same bf16 product."""
    from lfm_tpu_torch.kernels.gemm import gemm

    gen = generator(7000 + 2 * n + streams)
    rows = []
    for name, m, k, nn, epi, resid, aux, aux2 in gemm_cases(n, streams):
        a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        w = (k ** -0.5 * torch.randn(nn, k, generator=gen, device="cuda")).bfloat16()
        kw = dict(epilogue=epi, aux=aux, aux2=aux2,
                  bias=(0.02 * torch.randn(nn, generator=gen, device="cuda")).bfloat16())
        nbytes = 2 * (m * k + nn * k + nn) + m * nn * (2 + 2 * (aux + aux2))
        if resid is not None:
            kw.update(resid=torch.randn(m, nn, generator=gen, device="cuda").to(resid),
                      mod=(0.3 * torch.randn(n, 6 * nn, generator=gen, device="cuda")).bfloat16(),
                      gate=2 if name == "proj" else 5, tokens=T,
                      out_dtype=torch.float32 if resid == torch.bfloat16 else torch.bfloat16)
            nbytes += m * nn * (resid.itemsize + kw["out_dtype"].itemsize - 2) + 2 * n * nn
        flops = 2 * m * nn * k
        ms = time_ms(lambda: gemm(a, w, **kw), reps)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        rows.append({"gemm": name, "shape": [m, k, nn], "epilogue": epi,
                     "ms": ms, "tflops": flops / ms / 1e9, "bound_ms": bound,
                     "bound_share": bound / ms,
                     "matmul_ms": time_ms(lambda: torch.matmul(a, w.t()), reps)})
        del a, w, kw
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_block needs a CUDA card")
    import lfm_tpu_torch

    timing_only = "--timing-only" in sys.argv[1:]
    rows = ([bench_k2(n, timing_only) for n in K2_BATCHES]
            + [bench_k5(n, mode, timing_only) for n, mode in K5_CASES])
    result = {"package": lfm_tpu_torch.__file__, "rows": rows}
    try:
        import lfm_tpu_torch.kernels.gemm  # noqa: F401  (absent before the NT GEMM's wrapper)
    except ImportError:
        pass
    else:
        if not timing_only:
            result["gemms"] = {"fused_dit_block": gemm_rows(K2_BATCHES[0], False),
                               "dit_block_train_fwd": gemm_rows(K5_CASES[0][0], True)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    result["card"] = smi.stdout.strip()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
