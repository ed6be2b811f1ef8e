"""Times P1's int8 GEMM on the card at the w8a8 path's four products, alone
and inside ``int8_dense``, beside ``torch._int_mm`` on the same operands.

    python -m lfm_tpu_torch.tools.bench_int8 [--timing-only] [--sample]

or, to time another checkout's kernels on the same inputs (its package is
the one imported; its kernels are built in that checkout):

    PYTHONPATH=<other checkout> python <this checkout>/lfm_tpu_torch/tools/bench_int8.py

Shapes: DiT-L/2's block at the sampling batch, M = 200 x 256 = 51200 rows,
C = 1024, hidden 4096 (``chip_smoke.py``'s P1 rows): qkv (1024 -> 3072, bf16
out), proj (1024 -> 1024), fc1 (1024 -> 4096, + GELU) and fc2 (4096 ->
1024), f32 out but for qkv, each with a bias; then the two products of one
step of P1's probe (tools/microbench_int8.py: 16384 rows, D 1024, H 4096,
no bias). Inputs come from a CUDA generator seeded per product, so two
checkouts see the same values; the rows are quantized once by
``quant_rows``. For each product, each a mean of REPS launches after
WARMUP, REPEATS times, with CUDA events:

- ``gemm_ms``: the GEMM alone on the quantized rows, with TOP/s, its bound
  (the larger of its bytes, each operand read and the output written once,
  over 3.35 TB/s and 2 M N K over the 1979 TOP/s int8 peak) and the share
  of it, and the tile width the GEMM takes (``int8_gemm_tile``, where the
  checkout has it);
- ``dense_ms``: ``int8_dense`` (the row quantization and the GEMM);
- ``int_mm_ms``: ``torch._int_mm`` (cuBLASLt) of the same int8 operands to
  int32, the GEMM without its dequant.

Last come fc1's shape with its other epilogues (no GELU, bf16 out, both),
which split fc1's time between its products, its f32 stores and its GELU
(``chip_smoke.py`` times only the first six). Without ``--timing-only`` each product also gets the digest
of the GEMM's output bytes (equal outputs, equal digests, across
checkouts) and whether that output equals, bit for bit, the plain
version's and ``int8_dense``'s.

``--sample`` times the int8 path end to end instead, as ``chip_smoke.py``'s
``int8_main`` runs it: celeb256_dit's DiT-L/2 (seeded weights) and a seeded
full-width VAE, the w8a8 sampler (``use_int8_dit``, euler at 4 steps, VAE
decode) on batch 200 of the preset's noise, SAMPLE_RUNS wall-clock times
after a warm-up run (``sample_s``); and one int8 velocity evaluation
(``dit_int8_apply`` at t = 0.5 on that noise), a mean of EVAL_REPS after
WARMUP, REPEATS times, with CUDA events (``eval_ms``).

Prints one JSON line with the card's name and power limit and the file of
the package that ran. Needs a CUDA card.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys

import torch

M, C, HID = 51200, 1024, 4096
WARMUP, REPS, REPEATS = 3, 20, 3
SAMPLE_RUNS, EVAL_REPS = 3, 10
HBM_BYTES_PER_S, INT8_OPS = 3.35e12, 1979e12  # H100 SXM data sheet
BF, F32 = torch.bfloat16, torch.float32
# (name, M, K, N, epilogue, out dtype, x dtype, bias): the path's four as
# chip_smoke.py's P1 rows, then the probe step's two
PRODUCTS = (("qkv", M, C, 3 * C, "store", BF, F32, True),
            ("proj", M, C, C, "store", F32, BF, True),
            ("fc1", M, C, HID, "gelu", F32, F32, True),
            ("fc2", M, HID, C, "store", F32, F32, True),
            ("probe_fc1", 16384, C, HID, "gelu", F32, BF, False),
            ("probe_fc2", 16384, HID, C, "store", F32, F32, False))
# fc1's shape with the other epilogues the GEMM is built for
EPILOGUE_VARIANTS = (("fc1_store_f32", M, C, HID, "store", F32, F32, True),
                     ("fc1_gelu_bf16", M, C, HID, "gelu", BF, F32, True),
                     ("fc1_store_bf16", M, C, HID, "store", BF, F32, True))


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


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def product_inputs(m, k, n, x_dtype):
    """x (m, K), the int8 weight (N, K) with its scales, a bf16 bias, from a
    generator seeded by the product's shape."""
    from lfm_tpu_torch.nn.dit_int8 import quantize_weight

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9000 + m + k + n)
    x = torch.randn(m, k, generator=gen, device="cuda").to(x_dtype)
    qw, sw = quantize_weight(k ** -0.5 * torch.randn(n, k, generator=gen, device="cuda"))
    b = (0.02 * torch.randn(n, generator=gen, device="cuda")).bfloat16()
    return x, qw, sw, b


def gemm_rows(reps: int = REPS, repeats: int = REPEATS, check: bool = True,
              products=PRODUCTS):
    """One row per product: the GEMM alone, int8_dense and torch._int_mm,
    timed ``repeats`` times; with ``check``, the output digests and
    bit-equality with the plain version."""
    from lfm_tpu_torch.kernels import int8_matmul as p1

    rows = []
    for name, m, k, n, epi, odt, xdt, has_bias in products:
        x, qw, sw, b = product_inputs(m, k, n, xdt)
        b = b if has_bias else None
        qx, sx = p1.quant_rows(x)
        gelu = epi == "gelu"
        gemm = lambda: p1._launch_gemm(qx, sx, qw, sw, b, gelu, odt)  # noqa: E731
        ops = 2 * m * n * k
        nbytes = m * k + n * k + 4 * m + (6 if has_bias else 4) * n + m * n * odt.itemsize
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS) * 1e3
        ms = [time_ms(gemm, reps) for _ in range(repeats)]
        row = {"product": name, "shape": [m, k, n], "epilogue": epi, "out": str(odt),
               "gemm_ms": ms, "gemm_tops": ops / min(ms) / 1e9, "bound_ms": bound,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT8_OPS
               else "operations", "bound_share": bound / min(ms)}
        if hasattr(p1, "int8_gemm_tile"):
            # both consumer warpgroups on each tile: the only schedule
            row.update(tile_n=p1.int8_gemm_tile(n, k), schedule="cooperative")
        row["dense_ms"] = [time_ms(lambda: p1.int8_dense(x, qw, sw, b, epi, odt), reps)
                           for _ in range(repeats)]
        qwt = qw.t()
        row["int_mm_ms"] = [time_ms(lambda: torch._int_mm(qx, qwt), reps)
                            for _ in range(repeats)]
        if check:
            out = gemm()
            want = p1.reference_int8_dense(x, qw, sw, b, epi, odt)
            row.update(digest=digest(out), equals_plain=bool(torch.equal(out, want)),
                       dense_equals_gemm=bool(torch.equal(
                           p1.int8_dense(x, qw, sw, b, epi, odt), out)))
            del out, want
        rows.append(row)
        del x, qw, sw, b, qx, sx, qwt
    return rows


def sample_times() -> dict:
    """int8_main's sampling call and one int8 velocity evaluation, timed."""
    import dataclasses
    import time

    from lfm_tpu_torch.core.config import get_preset
    from lfm_tpu_torch.core.rng import SampleRNG
    from lfm_tpu_torch.nn.dit_int8 import dit_int8_apply, quantize_params_int8
    from lfm_tpu_torch.nn.factory import create_network
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.sample.sample import make_sampler, noise_and_labels
    from lfm_tpu_torch.vae.autoencoder_kl import create_vae

    dev = torch.device("cuda")
    preset = get_preset("celeb256_dit")
    config = dataclasses.replace(preset, sample=dataclasses.replace(
        preset.sample, use_int8_dit=True, method="euler", num_steps=4))
    model = create_network(config.model, dtype=torch.bfloat16,
                           use_flash=config.model.use_flash_attention, device=dev)
    seeded_init_(model, 0)
    vae = create_vae(dtype=torch.bfloat16, device=dev)
    seeded_init_(vae, 1)
    noise, y = noise_and_labels(config, SampleRNG(config.sample.seed),
                                range(config.sample.batch_size), device=dev)
    sampler = make_sampler(config, model, None, vae, None, device=dev)
    seconds = []
    for _ in range(SAMPLE_RUNS + 1):
        torch.cuda.synchronize()
        t0 = time.time()
        sampler(noise, y)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
    with torch.no_grad():
        qparams = quantize_params_int8(model, model.state_dict())
        tt = torch.full((noise.shape[0],), 0.5, device=dev)
        velocity = lambda: dit_int8_apply(model, qparams, tt, noise)  # noqa: E731
        eval_ms = [time_ms(velocity, EVAL_REPS) for _ in range(REPEATS)]
        v = velocity()
    return {"batch": int(noise.shape[0]), "sample_s": seconds[1:], "eval_ms": eval_ms,
            "velocity_digest": digest(v)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_int8 needs a CUDA card")
    import lfm_tpu_torch

    if "--sample" in sys.argv[1:]:
        line = sample_times()
    else:
        line = {"rows": gemm_rows(check="--timing-only" not in sys.argv[1:],
                                  products=PRODUCTS + EPILOGUE_VARIANTS)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(json.dumps({"package": lfm_tpu_torch.__file__, **line,
                      "card": smi.stdout.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
