#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``lfm_tpu_torch``) on one H100.

    python3 chip_smoke.py

Imports nothing of JAX or ``lfm_tpu``. Phases, each printing one JSON line:

1. build: nvcc builds ``lfm_tpu_torch/kernels/csrc/*.cu`` into one library.
2. kernels: each hand-written kernel against its plain PyTorch version on
   the same seeded bf16 inputs (attention_small at (8, 256, 16, 64),
   (2, 1024, 16, 64) and (N, 256, 16, 64); fused_dit_block at T=256,
   C=1024, hidden 4096, 16 heads, N=8 and N, every weight non-zero), with
   the error against the stated tolerance, the kernel's time, the plain
   version's time, the bound and, for attention,
   scaled_dot_product_attention's time. N is the preset's sampling batch
   (200), the main path's batch.
3. fused: ``make_sampler`` on the celeb256_dit preset, a bf16 DiT-L/2 at full
   width and depth with seeded non-zero weights, dopri5 at the preset's
   tolerances, full-size VAE decode of N samples to (N, 256, 256, 3);
   fused_dit_block must launch 24 x NFE times.
4. module: the same model with use_fused_dit=False, euler at 4 steps;
   attention_small must launch 24 x NFE times. The fused and module
   velocities at one (t, x) must agree.
5. a ``kernels`` line with every ported kernel, then the card's name and
   power limit, then the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the exit code is not 0. Without CUDA, or
without the package beside it, the script exits non-zero before printing
any result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
SEED = 0  # weights and kernel inputs
# K1: max abs error / max |plain| on bf16 outputs, a few bf16 ulps (2^-8
# relative): p rounded before or after normalisation, f32 sums in another order
K1_TOL = 2e-2
# K2: max |out - plain| / max |plain - x|, the error against the block's own
# update rather than the residual stream x, which would hide a wrong update;
# the floor is one bf16 ulp of the largest output (2^-5 at |out| in [4, 8))
# against an update of about 3, from roundings that fall the other way
K2_TOL = 2e-2
VEL_TOL = 5e-2  # fused vs module velocity, max abs / max |module| (as tests/test_dit_fused.py)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from lfm_tpu_torch.core.config import get_preset
    from lfm_tpu_torch.core.rng import SampleRNG
    from lfm_tpu_torch.kernels import _build
    from lfm_tpu_torch.kernels.dit_block import FUSED_DIT_BLOCK, fused_dit_block, reference_block
    from lfm_tpu_torch.kernels.flash_attention import (ATTENTION_SMALL, attention_small,
                                                       reference_attention)
    from lfm_tpu_torch.nn.dit_fused import cast_params_bf16, dit_fused_apply
    from lfm_tpu_torch.nn.factory import create_network
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.sample.sample import make_sampler, noise_and_labels
    from lfm_tpu_torch.vae.autoencoder_kl import create_vae

    dev = torch.device("cuda")
    bf = torch.bfloat16
    t_all = time.time()

    # 1. build
    t0 = time.time()
    lib_path = _build.build()
    _build.load_library()
    emit({"phase": "build", "seconds": time.time() - t0, "lib": os.path.relpath(lib_path)})

    # 2. kernels against their plain versions
    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(bf)

    config = get_preset("celeb256_dit")
    batch = config.sample.batch_size
    k1_rows, k2_rows = {}, {}
    for n, t, h, d in sorted({(8, 256, 16, 64), (2, 1024, 16, 64), (batch, 256, 16, 64)}):
        q, k, v = rn(n, t, h, d), rn(n, t, h, d), rn(n, t, h, d)
        out = attention_small(q, k, v)
        ref = reference_attention(q, k, v)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        rel = err / float(ref.float().abs().max())
        if not rel <= K1_TOL:
            raise AssertionError(f"attention_small {(n, t, h, d)}: max abs err {err} is {rel} "
                                 f"of max |plain| > {K1_TOL}")
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        bms, by = bound_ms(4 * n * t * h * d * 2, 4 * n * h * t * t * d)
        row = {"shape": [n, t, h, d], "max_abs_err": err, "rel_err": rel, "tol": K1_TOL,
               "ms": time_ms(torch, lambda: attention_small(q, k, v)),
               "plain_ms": time_ms(torch, lambda: reference_attention(q, k, v)),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh)),
               "bound_ms": bms, "bound_by": by}
        k1_rows[(n, t)] = row
        emit({"phase": "kernel", "name": "attention_small", **row})
        del q, k, v, qh, kh, vh, out, ref

    t, c, heads = 256, 1024, 16
    hid = 4 * c
    for n in sorted({8, batch}):
        blk = dict(x=rn(n, t, c), mod=rn(n, 6 * c, scale=0.3),
                   wqkv=rn(3 * c, c, scale=c ** -0.5), bqkv=rn(3 * c, scale=0.02),
                   wproj=rn(c, c, scale=c ** -0.5), bproj=rn(c, scale=0.02),
                   w1=rn(hid, c, scale=c ** -0.5), b1=rn(hid, scale=0.02),
                   w2=rn(c, hid, scale=hid ** -0.5), b2=rn(c, scale=0.02))
        out = fused_dit_block(**blk, num_heads=heads)
        ref = reference_block(**blk, num_heads=heads)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        update = float((ref.float() - blk["x"].float()).abs().max())
        rel = err / update
        if not rel <= K2_TOL:
            raise AssertionError(f"fused_dit_block N={n}: max abs err {err} is {rel} of "
                                 f"max |plain - x| > {K2_TOL}")
        nbytes = 2 * (2 * n * t * c + 6 * n * c + 4 * c * c + 2 * c * hid + 5 * c + hid)
        bms, by = bound_ms(nbytes, 2 * n * t * c * (4 * c + 2 * hid) + 4 * n * t * t * c)
        row = {"shape": [n, t, c, hid, heads], "max_abs_err": err, "max_update": update,
               "rel_err": rel, "tol": K2_TOL, "ms": time_ms(torch, lambda: fused_dit_block(**blk, num_heads=heads)),
               "plain_ms": time_ms(torch, lambda: reference_block(**blk, num_heads=heads)),
               "library_ms": None, "bound_ms": bms, "bound_by": by}
        k2_rows[n] = row
        emit({"phase": "kernel", "name": "fused_dit_block", **row})
        del blk, out, ref
    emit({"phase": "kernels_vs_plain", "seconds": time.time() - t0})

    # 3. main path, fused blocks: celeb256_dit, bf16 DiT-L/2, dopri5, VAE decode
    model = create_network(config.model, dtype=bf, use_flash=config.model.use_flash_attention,
                           device=dev)
    seeded_init_(model, SEED)
    vae = create_vae(dtype=bf, device=dev)
    seeded_init_(vae, SEED + 1)
    depth = model.depth
    noise, y = noise_and_labels(config, SampleRNG(config.sample.seed), range(batch),
                                device=dev)
    sampler = make_sampler(config, model, None, vae, None, device=dev)
    ATTENTION_SMALL.count = FUSED_DIT_BLOCK.count = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    res = sampler(noise, y)
    torch.cuda.synchronize()
    secs = time.time() - t0
    k2_launches, k1_in_fused = FUSED_DIT_BLOCK.count, ATTENTION_SMALL.count
    img = res.images
    emit({"phase": "main_fused", "seconds": secs, "method": config.sample.method,
          "atol": config.sample.atol, "rtol": config.sample.rtol, "nfe": res.nfe,
          "images": list(img.shape), "fused_dit_block_launches": k2_launches,
          "attention_small_launches": k1_in_fused,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "image_mean": float(img.float().mean()), "image_std": float(img.float().std())})
    if tuple(img.shape) != (batch, 256, 256, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not (bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0 and float(img.max()) <= 1.0):
        raise AssertionError("images are not finite values in [0, 1]")
    if not bool(torch.isfinite(res.latents).all()):
        raise AssertionError("latents are not finite")
    if k2_launches != depth * res.nfe or k1_in_fused != 0:
        raise AssertionError(f"fused path: {k2_launches} fused_dit_block launches for NFE "
                             f"{res.nfe} x depth {depth}; {k1_in_fused} attention_small")

    # 4. main path, module blocks: attention through attention_small
    mconfig = dataclasses.replace(config, sample=dataclasses.replace(
        config.sample, use_fused_dit=False, method="euler", num_steps=4))
    msampler = make_sampler(mconfig, model, None, vae, None, device=dev)
    ATTENTION_SMALL.count = FUSED_DIT_BLOCK.count = 0
    torch.cuda.synchronize()
    t0 = time.time()
    mres = msampler(noise, y)
    torch.cuda.synchronize()
    msecs = time.time() - t0
    k1_launches, k2_in_module = ATTENTION_SMALL.count, FUSED_DIT_BLOCK.count
    mimg = mres.images
    with torch.no_grad():
        tt = torch.full((batch,), 0.5, device=dev)
        v_fused = dit_fused_apply(model, cast_params_bf16(model.state_dict()), tt, noise)
        v_module = model(tt, noise)
    vel_err = float((v_fused - v_module).abs().max()) / float(v_module.abs().max())
    emit({"phase": "main_module", "seconds": msecs, "method": "euler", "nfe": mres.nfe,
          "images": list(mimg.shape), "attention_small_launches": k1_launches,
          "fused_dit_block_launches": k2_in_module, "velocity_rel_err": vel_err,
          "velocity_tol": VEL_TOL})
    if not (bool(torch.isfinite(mimg).all()) and tuple(mimg.shape) == tuple(img.shape)):
        raise AssertionError("module path images are not finite or have the wrong shape")
    if k1_launches != depth * mres.nfe or k2_in_module != 0:
        raise AssertionError(f"module path: {k1_launches} attention_small launches for NFE "
                             f"{mres.nfe} x depth {depth}; {k2_in_module} fused_dit_block")
    if not vel_err <= VEL_TOL:
        raise AssertionError(f"fused vs module velocity: {vel_err} > {VEL_TOL}")

    # 5. the kernels line, the card, the last line
    k1, k2_row = k1_rows[(batch, 256)], k2_rows[batch]
    emit({"kernels": [
        {"name": "attention_small", "route": "cuda",
         "source": "lfm_tpu_torch/kernels/csrc/attention.cuh",
         "replaces": "lfm_tpu/kernels/flash_attention.py:163", "launches": k1_launches,
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"]},
        {"name": "fused_dit_block", "route": "cuda",
         "source": "lfm_tpu_torch/kernels/csrc/dit_block.cu",
         "replaces": "lfm_tpu/kernels/dit_block.py:135", "launches": k2_launches,
         "max_abs_err": k2_row["max_abs_err"], "ms": k2_row["ms"],
         "plain_ms": k2_row["plain_ms"], "bound_ms": k2_row["bound_ms"],
         "bound_by": k2_row["bound_by"], "library_ms": None},
    ], "seconds_total": time.time() - t_all})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
