"""Times the port's attention kernels on the card, with each one's error
against its plain version.

    python -m lfm_tpu_torch.tools.bench_attention [--timing-only] [--long-f32] [--f64-seeds N]

or, to time another checkout's kernels on the same inputs (its package is
the one imported; its kernels are built in that checkout):

    PYTHONPATH=<other checkout> python <this checkout>/lfm_tpu_torch/tools/bench_attention.py

Shapes: ``attention_small`` in f32 at (200, 16, 4, 128) (celeb256_adm's
path, batch 200), (16, 64, 4, 128), (16, 16, 4, 256) and (16, 256, 4,
128) (the origin ADM's head past T = 64), at the f32 DiT's heads (8, 256,
16, 64), (32, 256, 16, 64) (DiT-L/2's train step with ``--precision
f32``) and (8, 256, 16, 72) (DiT-XL/2's head), and past T = 256 at (2,
1024, 16, 64) (an f32 DiT-L/2 at 512 px), (2, 512, 16, 64), the ragged
(2, 300, 16, 64) and (2, 1024, 16, 72), all on the thirds of a fused qkv
row as the models call it; in bf16 at (8, 256,
16, 72) and (32, 256, 16, 72); ``attention_small_bwd`` in bf16 at (32,
256, 16, 64) (the DiT-L/2 train step's shape) and (8, 1024, 16, 64), and
in f32 at the three f32 DiT shapes and past T = 256 at (2, 1024, 16, 64)
(an f32 DiT-L/2 at 512 px) and the ragged (2, 300, 16, 64) and (2, 300,
16, 80); ``flash_attention`` in f32 at (1, 4096, 4, 128) and (2, 4096, 16,
64) (an f32 DiT-L/2 at 1024 px), its default key blocks of 512. Inputs come
from a CUDA generator seeded per shape, so two checkouts see the same
values. Each kernel is timed with CUDA events, the mean of REPS
calls after WARMUP, REPEATS times (at these sizes a call can take less
device time than its host launch, so ``ms`` may be the host's rate), and
by ``torch.profiler`` as the device time of REPS calls over REPS
(``device_ms``, and ``device_kernels_ms`` by kernel); beside it the max abs error and the error relative to
max |plain| of each output, a digest of the output's bytes (two checkouts
that give the same bits give the same digest), and the same times of
``scaled_dot_product_attention`` (its backward through autograd for K3),
and the bound (bytes or operations at the card's peaks, as chip_smoke.py
counts them). f32 rows also give the error against the same function in
float64 (``rel_err_f64``): the plain version's f32 GEMMs sum in an order
of their own, so the error against them measures agreement with that
order as much as accuracy. ``--timing-only`` keeps the event times alone (the repeated
rounds of an A/B comparison); ``--long-f32`` keeps the f32 rows past T = 256
(K4, and K1 and K3 past T = 256) alone; ``--f64-seeds N`` gives, for those rows
alone, the kernel's and the plain version's error against float64 on N
seeded inputs each (seed 0 is the other modes' input), since a tensor's
largest error is one element's and varies from input to input. Prints one
JSON line with the card's name and power limit and the file of the package
that ran. Needs a CUDA card.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys

import torch

F32_DIT = ((8, 256, 16, 64), (32, 256, 16, 64), (8, 256, 16, 72))
# f32 past T = 256: an f32 DiT-L/2 at 512 px (K1, K3) and at 1024 px (K4),
# and ragged T; K1 also at T = 512 and DiT-XL/2's head, K4 at the origin
# ADM's D = 128
F32_LONG_K1 = ((2, 1024, 16, 64), (2, 512, 16, 64), (2, 300, 16, 64), (2, 1024, 16, 72))
F32_LONG_K3 = ((2, 1024, 16, 64), (2, 300, 16, 64), (2, 300, 16, 80))
K1_CASES = ([(s, torch.float32) for s in ((200, 16, 4, 128), (16, 64, 4, 128), (16, 16, 4, 256),
                                          (16, 256, 4, 128)) + F32_DIT + F32_LONG_K1]
            + [(s, torch.bfloat16) for s in ((8, 256, 16, 72), (32, 256, 16, 72))])
F32_LONG_K4 = ((1, 4096, 4, 128), (2, 4096, 16, 64))
K3_CASES = ([(s, torch.bfloat16) for s in ((32, 256, 16, 64), (8, 1024, 16, 64))]
            + [(s, torch.float32) for s in F32_DIT + F32_LONG_K3])
WARMUP, REPS, REPEATS = 3, 50, 3
# H100 SXM peaks (NVIDIA data sheet), as chip_smoke.py: HBM bytes/s, f32
# flop/s outside the tensor cores, dense bf16 tensor-core flop/s
HBM_BYTES_PER_S, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12


def time_ms(fn) -> float:
    for _ in range(WARMUP):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def device_ms(fn):
    """Device time of one call, in all and by kernel: the device rows of
    torch.profiler's trace of REPS calls (an operator's row repeats its
    kernels' time, so only the kernels' own rows are summed), over REPS."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    by_kernel = {e.key[:60]: e.self_device_time_total / REPS / 1e3
                 for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    return sum(by_kernel.values()), by_kernel


def device(fn, prefix: str = ""):
    total, by_kernel = device_ms(fn)
    return {prefix + "device_ms": total, prefix + "device_kernels_ms": by_kernel}


def digest(*tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def errors(got, want):
    err = float((got.float() - want.float()).abs().max())
    return err, err / float(want.float().abs().max())


def bound(nbytes: float, flops: float, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (F32_FLOPS if dtype == torch.float32 else BF16_FLOPS)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def attention_f64(q, k, v):
    """softmax(q k^T / sqrt(D)) v in float64, (N, T, H, D) in and out."""
    qd, kd, vd = (a.double() for a in (q, k, v))
    s = torch.einsum("nqhd,nkhd->nhqk", qd, kd) / q.shape[-1] ** 0.5
    return torch.einsum("nhqk,nkhd->nqhd", torch.softmax(s, dim=-1), vd)


def attention_bwd_f64(q, k, v, do):
    """(dq, dk, dv) of attention_f64, by autograd in float64."""
    leaves = [a.double().requires_grad_(True) for a in (q, k, v)]
    return torch.autograd.grad(attention_f64(*leaves), leaves, do.double())


def generator(shape, seed: int = 0) -> torch.Generator:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(sum(shape) + 1000 * seed)
    return gen


def bench_k1(shape, dtype, timing_only: bool):
    from lfm_tpu_torch.kernels.flash_attention import (attention_small, reference_attention,
                                                       split_qkv)

    n, t, h, d = shape
    qkv = torch.randn(n, t, 3 * h * d, generator=generator(shape), device="cuda").to(dtype)
    q, k, v = split_qkv(qkv, h)
    row = {"kernel": "attention_small", "dtype": str(dtype).removeprefix("torch."),
           "shape": list(shape),
           "ms": [time_ms(lambda: attention_small(q, k, v)) for _ in range(REPEATS)]}
    if timing_only:
        return row
    out = attention_small(q, k, v)
    err, rel = errors(out, reference_attention(q, k, v))
    if dtype == torch.float32:
        row["rel_err_f64"] = errors(out, attention_f64(q, k, v))[1]
    qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    esize = q.element_size()
    return {**row, "max_abs_err": err, "rel_err": rel, "digest": digest(out),
            **bound(4 * n * t * h * d * esize, 4 * n * h * t * t * d, dtype),
            **device(lambda: attention_small(q, k, v)),
            "library_ms": [time_ms(lambda: sdpa(qh, kh, vh)) for _ in range(REPEATS)],
            **device(lambda: sdpa(qh, kh, vh), "library_")}


def bench_k4(shape, dtype, timing_only: bool):
    from lfm_tpu_torch.kernels.flash_attention import flash_attention, reference_flash_attention

    gen = generator(shape)
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    row = {"kernel": "flash_attention", "dtype": str(dtype).removeprefix("torch."),
           "shape": list(shape),
           "ms": [time_ms(lambda: flash_attention(q, k, v)) for _ in range(REPEATS)]}
    if timing_only:
        return row
    out = flash_attention(q, k, v)
    err, rel = errors(out, reference_flash_attention(q, k, v))
    if dtype == torch.float32:
        row["rel_err_f64"] = errors(out, attention_f64(q, k, v))[1]
    qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n, t, h, d = shape
    return {**row, "max_abs_err": err, "rel_err": rel, "digest": digest(out),
            **bound(4 * n * t * h * d * q.element_size(), 4 * n * h * t * t * d, dtype),
            **device(lambda: flash_attention(q, k, v)),
            "library_ms": [time_ms(lambda: sdpa(qh, kh, vh)) for _ in range(REPEATS)],
            **device(lambda: sdpa(qh, kh, vh), "library_")}


def bench_k3(shape, dtype, timing_only: bool):
    from lfm_tpu_torch.kernels.flash_attention import attention_small_bwd, reference_attention_bwd

    gen = generator(shape)
    q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    row = {"kernel": "attention_small_bwd", "dtype": str(dtype).removeprefix("torch."),
           "shape": list(shape),
           "ms": [time_ms(lambda: attention_small_bwd(q, k, v, do)) for _ in range(REPEATS)]}
    if timing_only:
        return row
    got = attention_small_bwd(q, k, v, do)
    again = attention_small_bwd(q, k, v, do)
    errs = {name: errors(g, w) for name, g, w in zip(("dq", "dk", "dv"), got,
                                                      reference_attention_bwd(q, k, v, do))}
    if dtype == torch.float32:
        row["rel_err_f64"] = {name: errors(g, w)[1] for name, g, w in
                              zip(("dq", "dk", "dv"), got, attention_bwd_f64(q, k, v, do))}
    qh, kh, vh = (a.transpose(1, 2).contiguous().requires_grad_(True) for a in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    oh = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)

    def sdpa_bwd():
        torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)

    n, t, h, d = shape
    return {**row, "max_abs_err": {k: e[0] for k, e in errs.items()},
            "rel_err": {k: e[1] for k, e in errs.items()},
            "bit_identical_rerun": all(torch.equal(a, b) for a, b in zip(got, again)),
            "digest": digest(*got),
            **bound(7 * n * t * h * d * q.element_size(), 10 * n * h * t * t * d, dtype),
            **device(lambda: attention_small_bwd(q, k, v, do)),
            "library_ms": [time_ms(sdpa_bwd) for _ in range(REPEATS)],
            **device(sdpa_bwd, "library_")}


def f64_errors(seeds: int):
    """The f32 rows past T = 256, seed by seed: the errors of the kernel and
    of the plain version against float64 (per output for K3). K1's inputs
    are bench_k1's (the thirds of a qkv row)."""
    from lfm_tpu_torch.kernels.flash_attention import (attention_small, attention_small_bwd,
                                                       flash_attention, reference_attention,
                                                       reference_attention_bwd,
                                                       reference_flash_attention, split_qkv)

    rows = []
    for seed in range(seeds):
        for shape in F32_LONG_K1:
            n, t, h, d = shape
            qkv = torch.randn(n, t, 3 * h * d, generator=generator(shape, seed), device="cuda")
            q, k, v = split_qkv(qkv, h)
            f64 = attention_f64(q, k, v)
            rows.append({"kernel": "attention_small", "shape": list(shape), "seed": seed,
                         "rel_err_f64": errors(attention_small(q, k, v), f64)[1],
                         "plain_rel_err_f64": errors(reference_attention(q, k, v), f64)[1]})
            del qkv, q, k, v, f64
        for shape in F32_LONG_K4:
            gen = generator(shape, seed)
            q, k, v = (torch.randn(*shape, generator=gen, device="cuda") for _ in range(3))
            f64 = attention_f64(q, k, v)
            rows.append({"kernel": "flash_attention", "shape": list(shape), "seed": seed,
                         "rel_err_f64": errors(flash_attention(q, k, v), f64)[1],
                         "plain_rel_err_f64": errors(reference_flash_attention(q, k, v), f64)[1]})
            del q, k, v, f64
            torch.cuda.empty_cache()
        for shape in F32_LONG_K3:
            gen = generator(shape, seed)
            q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda") for _ in range(4))
            f64 = attention_bwd_f64(q, k, v, do)
            rows.append({"kernel": "attention_small_bwd", "shape": list(shape), "seed": seed,
                         **{key: {name: errors(g, w)[1] for name, g, w in zip(("dq", "dk", "dv"),
                                                                               got, f64)}
                            for key, got in (("rel_err_f64", attention_small_bwd(q, k, v, do)),
                                             ("plain_rel_err_f64",
                                              reference_attention_bwd(q, k, v, do)))}})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention needs a CUDA card")
    import lfm_tpu_torch

    timing_only = "--timing-only" in sys.argv[1:]
    if "--f64-seeds" in sys.argv[1:]:
        rows = f64_errors(int(sys.argv[sys.argv.index("--f64-seeds") + 1]))
    elif "--long-f32" in sys.argv[1:]:
        rows = ([bench_k1(s, torch.float32, timing_only) for s in F32_LONG_K1]
                + [bench_k4(s, torch.float32, timing_only) for s in F32_LONG_K4]
                + [bench_k3(s, torch.float32, timing_only) for s in F32_LONG_K3])
    else:
        rows = ([bench_k1(s, dt, timing_only) for s, dt in K1_CASES]
                + [bench_k3(s, dt, timing_only) for s, dt in K3_CASES]
                + [bench_k4(s, torch.float32, timing_only) for s in F32_LONG_K4])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(json.dumps({"package": lfm_tpu_torch.__file__, "card": smi.stdout.strip(),
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
