"""Times the port's K2 (``fused_dit_block``), K5 forward
(``block_train_fwd``), K5 mlp (``mlp_bwd``) and K5 attn (``attn_bwd``) on
the card, and each of their GEMMs alone, with each block's error against
its plain version.

    python -m lfm_tpu_torch.tools.bench_block [--timing-only] [--mlp | --attn] [--f64-seeds N]

or, to time another checkout's kernels on the same inputs (its package is
the one imported; its kernels are built in that checkout):

    PYTHONPATH=<other checkout> python <this checkout>/lfm_tpu_torch/tools/bench_block.py

Shapes: DiT-L/2's block (T = 256, C = 1024, hidden 4096, 16 heads); K2 at
N = 200 (the sampling batch) and 8, K5's forward with full and slim
streams at N = 32 (the train batch) and 8, K5 mlp and K5 attn at N = 32
and 8 on the kernel forward's own streams (K5 attn's cotangent dx1 is
seeded). Inputs come from a CUDA generator seeded
per case, so two checkouts see the same values. Each block is timed with
CUDA events, the mean of REPS calls after WARMUP, REPEATS times, and by
``torch.profiler`` as the device time of REPS calls over REPS, in all and
by kernel (``device_kernels_ms``: each GEMM, the attention and the
LayerNorms of the block apart); beside it the max abs error of each output
against the plain version, the error relative to max |plain| (for out and
x1, to max |plain - x|, the block's update; for dx1 to max |plain - dy|),
and a digest of the outputs' bytes (two checkouts that give the same bits
give the same digest). K5 mlp's and K5 attn's rows also give each
output's error against float64 (``rel_err_f64``, and
``plain_rel_err_f64`` for the plain version): ``mlp_bwd_f64`` and
``attn_bwd_f64`` keep the plain version's bf16 roundings (h2b, gb, dh2b,
du; hb, dpr, do, dqkv) and take every product and sum in float64; and K5
attn's the time of autograd's backward of the same half from library calls
(``library_ms``: cuBLAS, layer_norm, SDPA; events, which count the host's
autograd engine where it is slower than the card, and
``library_device_ms``, the profiler's device time). Where the checkout has the
GEMM's own wrappers (``kernels/gemm.py``), each of the blocks' GEMMs is
also timed alone at K2's N = 200 and K5's N = 32 (``gemm_rows``,
``mlp_gemm_rows`` and ``attn_gemm_rows``, which ``chip_smoke.py``'s
``gemm_redesign`` line reuses): ms, TFLOP/s, share of its bound, tile
width, and ``torch.matmul`` of the same bf16 product.
``--timing-only`` skips the plain versions and the profiler (the repeated
runs of an A/B comparison); ``--mlp`` (``--attn``) keeps the K5 mlp (K5
attn) rows and their GEMMs alone;
``--f64-seeds N`` gives, for K5 mlp (with ``--attn``, K5 attn) alone, the
kernel's and the plain version's error against float64 on N seeded inputs
each (seed 0 is the other modes' input), since a tensor's largest error is
one element's and varies from input to input. Prints one JSON line with
the card's name and power limit and the file of the package that ran.
Needs a CUDA card.
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
MLP_BATCHES = (32, 8)
MLP_OUTPUTS = ("dx1", "dmod", "dw1", "db1", "dw2", "db2")
ATTN_OUTPUTS = ("dx", "dmod", "dwqkv", "dbqkv", "dwproj", "dbproj")
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
    """{name: (max abs error, relative error)}; out and x1 (dx1, dx)
    relative to the block's update max |plain - x| (max |plain - dy|, max
    |plain - dx1|), the others to max |plain|."""
    errs = {}
    for name, g, w in zip(names, got, want):
        err = float((g.double() - w.double()).abs().max())
        ref = (w.double() - x.double()) if name in ("out", "x1", "dx1", "dx") else w.double()
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


def mlp_inputs(n: int, seed: int = 0):
    """K5 mlp's operands at batch n: the kernel forward's streams of a
    seeded block (x1, mod, h2, u, w1, w2) and a seeded dy."""
    from lfm_tpu_torch.kernels.dit_block_train import block_train_fwd

    gen = generator(9000 + n + 1000 * seed)
    blk = block_inputs(n, gen)
    _, x1, h2, _, _, _, u = block_train_fwd(**blk, num_heads=HEADS)
    dy = torch.randn(n, T, C, generator=gen, device="cuda").bfloat16()
    return x1, blk["mod"], h2, u, blk["w1"], blk["w2"], dy


def mlp_bwd_f64(x1, mod, h2, u, w1, w2, dy):
    """``reference_mlp_bwd``'s outputs with its bf16 roundings (h2b, gb, dh2b
    and du rounded as it rounds them, from its f32 values) and every product
    and sum in float64."""
    from lfm_tpu_torch.kernels.dit_block_train import (_gelu_tanh, _gelu_tanh_grad, _ln_bwd,
                                                       _ln_fwd_parts, _mm_f32, _mod_vectors)

    bf, f64 = torch.bfloat16, torch.float64
    n, t, c = x1.shape
    rows = n * t
    sh, sc, g = _mod_vectors(mod, n, c)[3:]
    n2f, _ = _ln_fwd_parts(x1.float())
    h2b = (n2f * (1.0 + sc) + sh).to(bf).reshape(rows, c).to(f64)
    uf = u.float().reshape(rows, -1)
    gb = _gelu_tanh(uf)[0].to(bf).to(f64)
    dh2b = (dy.float() * g).to(bf).reshape(rows, c)
    dub = (_mm_f32(dh2b, w2) * _gelu_tanh_grad(uf, _gelu_tanh(uf)[1])).to(bf).to(f64)
    dh2b = dh2b.to(f64)
    ud = u.to(f64).reshape(rows, -1)
    du = (dh2b @ w2.to(f64)) * _gelu_tanh_grad(ud, _gelu_tanh(ud)[1])
    dyd, gd, scd = dy.to(f64), g.to(f64), sc.to(f64)
    n2, r2 = _ln_fwd_parts(x1.to(f64))
    dh = (dub @ w1.to(f64)).reshape(n, t, c)
    dmod = torch.stack([dh.sum(dim=1), (dh * n2).sum(dim=1), (dyd * h2.to(f64)).sum(dim=1)],
                       dim=1)
    dx1 = dyd + _ln_bwd(dh * (1.0 + scd), n2, r2)
    return (dx1, dmod, dub.T @ h2b, du.sum(dim=0), dh2b.T @ gb,
            (dyd * gd).reshape(rows, c).sum(dim=0))


def bench_mlp(n: int, timing_only: bool):
    from lfm_tpu_torch.kernels.dit_block_train import mlp_bwd, reference_mlp_bwd

    margs = mlp_inputs(n)
    run = lambda: mlp_bwd(*margs)  # noqa: E731
    row = {"kernel": "dit_block_train_mlp_bwd", "shape": [n, T, C, HID, HEADS],
           "ms": [time_ms(run) for _ in range(REPEATS)]}
    if not timing_only:
        got, again = run(), run()
        errs = errors(MLP_OUTPUTS, got, reference_mlp_bwd(*margs), margs[-1])
        f64 = mlp_bwd_f64(*margs)
        row.update(max_abs_err={k: e[0] for k, e in errs.items()},
                   rel_err={k: e[1] for k, e in errs.items()},
                   rel_err_f64={k: e[1] for k, e in errors(MLP_OUTPUTS, got, f64,
                                                           margs[-1]).items()},
                   digest=digest(*got), bit_identical_rerun=digest(*again) == digest(*got),
                   **device_ms(run))
    return row


def mlp_f64_errors(seeds: int):
    """K5 mlp, seed by seed: the errors of the kernel and of the plain
    version against float64, per output."""
    from lfm_tpu_torch.kernels.dit_block_train import mlp_bwd, reference_mlp_bwd

    rows = []
    for seed in range(seeds):
        for n in MLP_BATCHES:
            margs = mlp_inputs(n, seed)
            f64 = mlp_bwd_f64(*margs)
            rows.append({"kernel": "dit_block_train_mlp_bwd", "shape": [n, T, C, HID, HEADS],
                         "seed": seed,
                         **{key: {k: e[1] for k, e in errors(MLP_OUTPUTS, fn(*margs), f64,
                                                             margs[-1]).items()}
                            for key, fn in (("rel_err_f64", mlp_bwd),
                                            ("plain_rel_err_f64", reference_mlp_bwd))}})
            del margs, f64
            torch.cuda.empty_cache()
    return rows


def mlp_gemm_rows(n: int, reps: int = REPS):
    """The four GEMMs of K5 mlp at batch n alone, through ``kernels.gemm``'s
    NN and TN wrappers on seeded inputs of its shapes (M = n T token rows):
    du = (dh2b W2) gelu'(u) with db1's column sums and gb (NN, dgelu), dW2 =
    dh2b^T gb (TN), dh = du W1 (NN) and dW1 = du^T h2b (TN); ms, TFLOP/s,
    the bound (the larger of bytes / 3.35 TB/s and 2 M N K / 989 TFLOP/s)
    and its share, the tile width and CTAs (no split of K), and
    ``torch.matmul`` of the same bf16 product."""
    from lfm_tpu_torch.kernels.gemm import gemm_nn, gemm_tile, gemm_tn

    gen = generator(8000 + n)
    m = n * T

    def rn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).bfloat16()

    dh2b, gb, du, h2b = rn(m, C), rn(m, HID), rn(m, HID), rn(m, C)
    w1, w2, u = rn(HID, C, scale=HID ** -0.5), rn(C, HID, scale=C ** -0.5), rn(m, HID)
    cases = (("du", "nn", m, C, HID, lambda: gemm_nn(dh2b, w2, epilogue="dgelu", u=u),
              lambda: torch.matmul(dh2b, w2), 2 * (m * C + C * HID + 3 * m * HID)
              + 4 * -(-m // 128) * HID),
             ("dw2", "tn", C, m, HID, lambda: gemm_tn(dh2b, gb),
              lambda: torch.matmul(dh2b.t(), gb), 2 * (m * C + m * HID) + 4 * C * HID),
             ("dh", "nn", m, HID, C, lambda: gemm_nn(du, w1), lambda: torch.matmul(du, w1),
              2 * (m * HID + HID * C) + 4 * m * C),
             ("dw1", "tn", HID, m, C, lambda: gemm_tn(du, h2b),
              lambda: torch.matmul(du.t(), h2b), 2 * (m * HID + m * C) + 4 * HID * C))
    rows = []
    for name, layout, mm, k, nn, run, matmul, nbytes in cases:
        flops = 2 * mm * nn * k
        ms = time_ms(run, reps)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        tile, ctas = gemm_tile(mm, nn)
        rows.append({"gemm": name, "layout": layout, "shape": [mm, k, nn], "ms": ms,
                     "tflops": flops / ms / 1e9, "bound_ms": bound, "bound_share": bound / ms,
                     "tile_n": tile, "ctas": ctas, "k_splits": 1,
                     "matmul_ms": time_ms(matmul, reps)})
    return rows


def attn_inputs(n: int, seed: int = 0):
    """K5 attn's operands at batch n: the kernel forward's streams of a
    seeded block (x, mod, pr, qkv, ao, wqkv, wproj) and a seeded dx1."""
    from lfm_tpu_torch.kernels.dit_block_train import block_train_fwd

    gen = generator(11000 + n + 1000 * seed)
    blk = block_inputs(n, gen)
    _, _, _, pr, qkv, ao, _ = block_train_fwd(**blk, num_heads=HEADS)
    dx1 = torch.randn(n, T, C, generator=gen, device="cuda").bfloat16()
    return blk["x"], blk["mod"], pr, qkv, ao, blk["wqkv"], blk["wproj"], dx1


def attn_bwd_f64(x, mod, pr, qkv, ao, wqkv, wproj, dx1):
    """``reference_attn_bwd``'s outputs with its bf16 roundings (hb, dpr, do
    and dqkv as it rounds them, from its f32 values; dqkv is K3's plain
    version) and every product and sum after them in float64."""
    from lfm_tpu_torch.kernels.dit_block_train import (_ln_bwd, _ln_fwd_parts, _mm_f32,
                                                       _mod_vectors)
    from lfm_tpu_torch.kernels.flash_attention import reference_attention_bwd, split_qkv

    bf, f64 = torch.bfloat16, torch.float64
    n, t, c = x.shape
    rows = n * t
    sh, sc, g = _mod_vectors(mod, n, c)[:3]
    n1f, _ = _ln_fwd_parts(x.float())
    hb = (n1f * (1.0 + sc) + sh).to(bf).reshape(rows, c).to(f64)
    dprb = (dx1.float() * g).to(bf).reshape(rows, c)
    do = _mm_f32(dprb, wproj).to(bf)
    q, k, v = split_qkv(qkv, HEADS)
    dqkv = torch.stack(reference_attention_bwd(q, k, v, do.reshape(q.shape)),
                       dim=2).reshape(rows, 3 * c).to(f64)
    dx1d, gd, scd = dx1.to(f64), g.to(f64), sc.to(f64)
    n1, r1 = _ln_fwd_parts(x.to(f64))
    dhb = (dqkv @ wqkv.to(f64)).reshape(n, t, c)
    dmod = torch.stack([dhb.sum(dim=1), (dhb * n1).sum(dim=1), (dx1d * pr.to(f64)).sum(dim=1)],
                       dim=1)
    dx = dx1d + _ln_bwd(dhb * (1.0 + scd), n1, r1)
    return (dx, dmod, dqkv.T @ hb, dqkv.sum(dim=0), dprb.to(f64).T @ ao.reshape(rows, c).to(f64),
            (dx1d * gd).reshape(rows, c).sum(dim=0))


def library_attn_bwd(x, mod, wqkv, bqkv, wproj, dx1):
    """A closure running autograd's backward of the block's attention half
    composed of library calls (cuBLAS bf16 matmuls, layer_norm,
    scaled_dot_product_attention; chip_smoke.py's library_attn_half), its
    forward graph built once: K5 attn's yardstick of speed."""
    F = torch.nn.functional
    leaves = [a.detach().requires_grad_(True) for a in (x, mod, wqkv, bqkv, wproj)]
    xl, ml, wq, bq, wp = leaves
    n, t, c = x.shape
    m = ml.reshape(n, 6, 1, c)
    h = F.layer_norm(xl, (c,), eps=1e-6) * (1 + m[:, 1]) + m[:, 0]
    q, k, v = F.linear(h, wq, bq).view(n, t, 3, HEADS, c // HEADS).permute(2, 0, 3, 1, 4)
    ao = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(n, t, c)
    out = xl + m[:, 2] * F.linear(ao, wp)
    return lambda: torch.autograd.grad(out, leaves, dx1, retain_graph=True)


def bench_attn(n: int, timing_only: bool):
    from lfm_tpu_torch.kernels.dit_block_train import attn_bwd, reference_attn_bwd

    aargs = attn_inputs(n)
    run = lambda: attn_bwd(*aargs, num_heads=HEADS)  # noqa: E731
    row = {"kernel": "dit_block_train_attn_bwd", "shape": [n, T, C, HID, HEADS],
           "ms": [time_ms(run) for _ in range(REPEATS)]}
    if not timing_only:
        got, again = run(), run()
        errs = errors(ATTN_OUTPUTS, got, reference_attn_bwd(*aargs, num_heads=HEADS), aargs[-1])
        f64 = attn_bwd_f64(*aargs)
        x, mod, _, _, _, wqkv, wproj, dx1 = aargs
        lib = library_attn_bwd(x, mod, wqkv, torch.zeros(3 * C, dtype=torch.bfloat16,
                                                         device="cuda"), wproj, dx1)
        row.update(max_abs_err={k: e[0] for k, e in errs.items()},
                   rel_err={k: e[1] for k, e in errs.items()},
                   rel_err_f64={k: e[1] for k, e in errors(ATTN_OUTPUTS, got, f64,
                                                           aargs[-1]).items()},
                   digest=digest(*got), bit_identical_rerun=digest(*again) == digest(*got),
                   library_ms=[time_ms(lib) for _ in range(REPEATS)],
                   library_device_ms=device_ms(lib)["device_ms"], **device_ms(run))
    return row


def attn_f64_errors(seeds: int):
    """K5 attn, seed by seed: the errors of the kernel and of the plain
    version against float64, per output."""
    from lfm_tpu_torch.kernels.dit_block_train import attn_bwd, reference_attn_bwd

    rows = []
    for seed in range(seeds):
        for n in MLP_BATCHES:
            aargs = attn_inputs(n, seed)
            f64 = attn_bwd_f64(*aargs)
            rows.append({"kernel": "dit_block_train_attn_bwd", "shape": [n, T, C, HID, HEADS],
                         "seed": seed,
                         **{key: {k: e[1] for k, e in errors(
                             ATTN_OUTPUTS, fn(*aargs, num_heads=HEADS), f64, aargs[-1]).items()}
                            for key, fn in (("rel_err_f64", attn_bwd),
                                            ("plain_rel_err_f64", reference_attn_bwd))}})
            del aargs, f64
            torch.cuda.empty_cache()
    return rows


def attn_gemm_rows(n: int, reps: int = REPS):
    """The four GEMMs of K5 attn at batch n alone, through ``kernels.gemm``'s
    NN and TN wrappers on seeded inputs of its shapes (M = n T token rows):
    do = bf16(dpr Wproj) (NN into bf16), dWproj = dpr^T ao (TN), dhb = dqkv
    Wqkv (NN) and dWqkv = dqkv^T hb (TN); the columns of mlp_gemm_rows.
    None in a checkout whose NN wrapper has no bf16 store (K5 attn's GEMMs
    were not yet on this kernel)."""
    import inspect

    from lfm_tpu_torch.kernels.gemm import gemm_nn, gemm_tile, gemm_tn

    if "out_dtype" not in inspect.signature(gemm_nn).parameters:
        return None
    gen = generator(10000 + n)
    m = n * T

    def rn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).bfloat16()

    dpr, ao, dqkv, hb = rn(m, C), rn(m, C), rn(m, 3 * C), rn(m, C)
    wproj, wqkv = rn(C, C, scale=C ** -0.5), rn(3 * C, C, scale=C ** -0.5)
    cases = (("do", "nn", m, C, C, lambda: gemm_nn(dpr, wproj, out_dtype=torch.bfloat16),
              lambda: torch.matmul(dpr, wproj), 2 * (2 * m * C + C * C)),
             ("dwproj", "tn", C, m, C, lambda: gemm_tn(dpr, ao),
              lambda: torch.matmul(dpr.t(), ao), 2 * 2 * m * C + 4 * C * C),
             ("dhb", "nn", m, 3 * C, C, lambda: gemm_nn(dqkv, wqkv),
              lambda: torch.matmul(dqkv, wqkv), 2 * (3 * m * C + 3 * C * C) + 4 * m * C),
             ("dwqkv", "tn", 3 * C, m, C, lambda: gemm_tn(dqkv, hb),
              lambda: torch.matmul(dqkv.t(), hb), 2 * 4 * m * C + 4 * 3 * C * C))
    rows = []
    for name, layout, mm, k, nn, run, matmul, nbytes in cases:
        flops = 2 * mm * nn * k
        ms = time_ms(run, reps)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        tile, ctas = gemm_tile(mm, nn)
        rows.append({"gemm": name, "layout": layout, "shape": [mm, k, nn], "ms": ms,
                     "tflops": flops / ms / 1e9, "bound_ms": bound, "bound_share": bound / ms,
                     "tile_n": tile, "ctas": ctas, "k_splits": 1,
                     "matmul_ms": time_ms(matmul, reps)})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_block needs a CUDA card")
    import lfm_tpu_torch

    args = sys.argv[1:]
    timing_only = "--timing-only" in args
    if "--f64-seeds" in args:
        f64_errors = attn_f64_errors if "--attn" in args else mlp_f64_errors
        result = {"rows": f64_errors(int(args[args.index("--f64-seeds") + 1]))}
    elif "--mlp" in args:
        result = {"rows": [bench_mlp(n, timing_only) for n in MLP_BATCHES]}
        if not timing_only:
            result["gemms"] = {"dit_block_train_mlp_bwd": mlp_gemm_rows(MLP_BATCHES[0])}
    elif "--attn" in args:
        result = {"rows": [bench_attn(n, timing_only) for n in MLP_BATCHES]}
        if not timing_only:
            result["gemms"] = {"dit_block_train_attn_bwd": attn_gemm_rows(MLP_BATCHES[0])}
    else:
        result = {"rows": [bench_k2(n, timing_only) for n in K2_BATCHES]
                  + [bench_k5(n, mode, timing_only) for n, mode in K5_CASES]
                  + [bench_mlp(n, timing_only) for n in MLP_BATCHES]
                  + [bench_attn(n, timing_only) for n in MLP_BATCHES]}
        if not timing_only:
            result["gemms"] = {"fused_dit_block": gemm_rows(K2_BATCHES[0], False),
                               "dit_block_train_fwd": gemm_rows(K5_CASES[0][0], True),
                               "dit_block_train_mlp_bwd": mlp_gemm_rows(MLP_BATCHES[0]),
                               "dit_block_train_attn_bwd": attn_gemm_rows(MLP_BATCHES[0])}
    result["package"] = lfm_tpu_torch.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    result["card"] = smi.stdout.strip()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
