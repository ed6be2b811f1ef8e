"""Times the port's f32 K1 at the origin ADM's short sequences and its bf16
K3 on the card, with each one's error against its plain version.

    python -m lfm_tpu_torch.tools.bench_attention

or, to time another checkout's kernels on the same inputs (its package is
the one imported; its kernels are built in that checkout):

    PYTHONPATH=<other checkout> python <this checkout>/lfm_tpu_torch/tools/bench_attention.py

Shapes: ``attention_small`` in f32 at (200, 16, 4, 128) (celeb256_adm's
path, batch 200), (16, 64, 4, 128) and (16, 16, 4, 256), on the thirds of
a fused qkv row as the ADM calls it; ``attention_small_bwd`` in bf16 at
(32, 256, 16, 64) (the DiT-L/2 train step's shape) and (8, 1024, 16, 64).
Inputs come from a CUDA generator seeded per shape, so two checkouts see
the same values. Each kernel is timed with CUDA events, the mean of REPS
calls after WARMUP, REPEATS times (at these sizes a call can take less
device time than its host launch, so ``ms`` may be the host's rate), and
by ``torch.profiler`` as the device time of REPS calls over REPS
(``device_ms``, and ``device_kernels_ms`` by kernel); beside it the max abs error and the error relative to
max |plain| of each output, a digest of the output's bytes (two checkouts
that give the same bits give the same digest), and the same times of
``scaled_dot_product_attention`` (its backward through autograd for K3).
Prints one JSON line with the card's name and power limit and the file of
the package that ran. Needs a CUDA card.
"""

from __future__ import annotations

import hashlib
import json
import subprocess

import torch

K1_SHAPES = ((200, 16, 4, 128), (16, 64, 4, 128), (16, 16, 4, 256))
K3_SHAPES = ((32, 256, 16, 64), (8, 1024, 16, 64))
WARMUP, REPS, REPEATS = 3, 50, 3


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


def generator(shape) -> torch.Generator:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(sum(shape))
    return gen


def bench_k1(shape):
    from lfm_tpu_torch.kernels.flash_attention import (attention_small, reference_attention,
                                                       split_qkv)

    n, t, h, d = shape
    qkv = torch.randn(n, t, 3 * h * d, generator=generator(shape), device="cuda")
    q, k, v = split_qkv(qkv, h)
    out = attention_small(q, k, v)
    err, rel = errors(out, reference_attention(q, k, v))
    qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return {"kernel": "attention_small", "dtype": "float32", "shape": list(shape),
            "max_abs_err": err, "rel_err": rel, "digest": digest(out),
            "ms": [time_ms(lambda: attention_small(q, k, v)) for _ in range(REPEATS)],
            **device(lambda: attention_small(q, k, v)),
            "library_ms": [time_ms(lambda: sdpa(qh, kh, vh)) for _ in range(REPEATS)],
            **device(lambda: sdpa(qh, kh, vh), "library_")}


def bench_k3(shape):
    from lfm_tpu_torch.kernels.flash_attention import attention_small_bwd, reference_attention_bwd

    gen = generator(shape)
    q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda").bfloat16() for _ in range(4))
    got = attention_small_bwd(q, k, v, do)
    again = attention_small_bwd(q, k, v, do)
    errs = {name: errors(g, w) for name, g, w in zip(("dq", "dk", "dv"), got,
                                                      reference_attention_bwd(q, k, v, do))}
    qh, kh, vh = (a.transpose(1, 2).contiguous().requires_grad_(True) for a in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    oh = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)

    def sdpa_bwd():
        torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)

    return {"kernel": "attention_small_bwd", "dtype": "bfloat16", "shape": list(shape),
            "max_abs_err": {k: e[0] for k, e in errs.items()},
            "rel_err": {k: e[1] for k, e in errs.items()},
            "bit_identical_rerun": all(torch.equal(a, b) for a, b in zip(got, again)),
            "digest": digest(*got),
            "ms": [time_ms(lambda: attention_small_bwd(q, k, v, do)) for _ in range(REPEATS)],
            **device(lambda: attention_small_bwd(q, k, v, do)),
            "library_ms": [time_ms(sdpa_bwd) for _ in range(REPEATS)],
            **device(sdpa_bwd, "library_")}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention needs a CUDA card")
    import lfm_tpu_torch

    rows = [bench_k1(s) for s in K1_SHAPES] + [bench_k3(s) for s in K3_SHAPES]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(json.dumps({"package": lfm_tpu_torch.__file__, "card": smi.stdout.strip(),
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
