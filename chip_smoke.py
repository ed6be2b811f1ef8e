#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``lfm_tpu_torch``) on one H100.

    python3 chip_smoke.py

Imports nothing of JAX or ``lfm_tpu``. Phases, each printing JSON lines:

1. build: nvcc builds ``lfm_tpu_torch/kernels/csrc/*.cu`` into one library,
   in a thread, while the main path's DiT-L/2 is made with seeded non-zero
   weights and saved as the ``model_0.pth`` that phase 6 starts from.
2. kernels: each hand-written kernel against its plain PyTorch version on
   the same seeded inputs, with the error against the stated tolerance, the
   kernel's time, the plain version's time, the bound and the time of one
   library call computing the same function:
   - attention_small (K1), bf16 at (8, 256, 16, 64), (2, 1024, 16, 64),
     (32, 256, 16, 64) (the train step's shape) and (N, 256, 16, 64), and
     f32 at (8, 256, 16, 64); library: scaled_dot_product_attention;
   - fused_dit_block (K2) at T=256, C=1024, hidden 4096, 16 heads, N=8 and
     N, every weight non-zero; library: the same block composed of cuBLAS
     bf16 matmuls and scaled_dot_product_attention;
   - attention_small_bwd (K3), bf16 at (32, 256, 16, 64) and
     (8, 1024, 16, 64), f32 at (8, 256, 16, 64); library: the backward of
     scaled_dot_product_attention through autograd (its saved forward
     graph, backward alone).
   N is the preset's sampling batch (200), the sampling path's batch.
3. grad: a 2-block DiT at DiT-L width (C = 1024, 16 heads, T = 256), batch
   8, bf16 compute on f32 masters; the flow-matching loss's parameter
   gradients with attention through K1/K3 against plain autograd of
   reference_attention, per tensor.
4. main_fused: ``make_sampler`` on the celeb256_dit preset, a bf16 DiT-L/2
   at full width and depth with seeded non-zero weights, dopri5 at the
   preset's tolerances, full-size VAE decode of N samples to
   (N, 256, 256, 3); fused_dit_block must launch 24 x NFE times.
5. main_module: the same model with use_fused_dit=False, euler at 4 steps;
   attention_small must launch 24 x NFE times. The fused and module
   velocities at one (t, x) must agree.
6. train: ``train(...)`` on the celeb256_dit preset (DiT-L/2 at full width
   and depth, batch 32, bf16 on f32 masters, grad checkpointing, EMA), from
   seeded non-zero weights given as a ``model_0.pth``, with a full-width
   seeded VAE encoder over synthetic 256^2 images in [-1, 1], below one
   epoch so no demo plot runs. A run of 1 step (which also warms the card
   up) checks the EMA against decay * p0 + (1 - decay) * p1 and that the
   parameters moved; a run of TRAIN_STEPS steps counts K3 launches (24 per
   step) and K1 launches (2 x 24 per step, the forward and its
   recompute). The loop logs, and so waits for the loss, after step 1;
   the time from that log call to the end of the run, after a sync, over
   TRAIN_STEPS - 1 is the seconds per step.
7. a ``kernels`` line with every ported kernel, then the card's name and
   power limit, then the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the exit code is not 0. Without CUDA, or
without the package beside it, the script exits non-zero before printing
any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# flop/s, f32 flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SEED = 0  # weights and kernel inputs
# K1: max abs error / max |plain| on bf16 outputs, a few bf16 ulps (2^-8
# relative): p rounded before or after normalisation, f32 sums in another order
K1_TOL = 2e-2
# K2: max |out - plain| / max |plain - x|, the error against the block's own
# update rather than the residual stream x, which would hide a wrong update;
# the floor is one bf16 ulp of the largest output (2^-5 at |out| in [4, 8))
# against an update of about 3, from roundings that fall the other way
K2_TOL = 2e-2
# K3: max abs error / max |plain| for each of dq, dk, dv in bf16: p and ds
# round to bf16 on both sides, and a rounding that falls the other way moves
# a term by 2^-8
K3_TOL = 2e-2
# f32 kernels (K1, K3): f32 sums in another order
F32_TOL = 1e-4
VEL_TOL = 5e-2  # fused vs module velocity, max abs / max |module| (as tests/test_dit_fused.py)
# DiT parameter gradients through K1/K3 vs plain autograd: max abs error /
# max |plain| per tensor, the bf16 tolerance of the CPU parity tests
GRAD_TOL = 5e-2
TRAIN_STEPS = 12  # the first step is not timed


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
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


def rel_err(a, b):
    err = float((a.float() - b.float()).abs().max())
    return err, err / float(b.float().abs().max())


def library_block(F, x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2, *, num_heads):
    """K2's block from library calls: cuBLAS bf16 matmuls, layer_norm and
    scaled_dot_product_attention. A yardstick of speed only."""
    n, t, c = x.shape
    m = mod.reshape(n, 6, 1, c)
    h = F.layer_norm(x, (c,), eps=1e-6) * (1 + m[:, 1]) + m[:, 0]
    q, k, v = F.linear(h, wqkv, bqkv).view(n, t, 3, num_heads, c // num_heads).permute(2, 0, 3, 1, 4)
    ao = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(n, t, c)
    x1 = x + m[:, 2] * F.linear(ao, wproj, bproj)
    h = F.layer_norm(x1, (c,), eps=1e-6) * (1 + m[:, 4]) + m[:, 3]
    return x1 + m[:, 5] * F.linear(F.gelu(F.linear(h, w1, b1), approximate="tanh"), w2, b2)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(torch, work: str) -> int:
    """The phases of the module docstring; ``work`` holds the train phase's
    files."""
    import torch.nn.functional as F

    from lfm_tpu_torch.core.config import get_preset
    from lfm_tpu_torch.core.rng import SampleRNG
    from lfm_tpu_torch.data import SyntheticImageDataset
    from lfm_tpu_torch.kernels import _build
    from lfm_tpu_torch.kernels.dit_block import FUSED_DIT_BLOCK, fused_dit_block, reference_block
    from lfm_tpu_torch.kernels.flash_attention import (ATTENTION_SMALL, ATTENTION_SMALL_BWD,
                                                       attention_small, attention_small_bwd,
                                                       reference_attention,
                                                       reference_attention_bwd)
    from lfm_tpu_torch.nn.dit import DiT
    from lfm_tpu_torch.nn.dit_fused import cast_params_bf16, dit_fused_apply
    from lfm_tpu_torch.nn.factory import create_network
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.ode.flow import interpolate
    from lfm_tpu_torch.sample.sample import make_sampler, noise_and_labels
    from lfm_tpu_torch.train.loop import train
    from lfm_tpu_torch.vae.autoencoder_kl import create_vae

    dev = torch.device("cuda")
    bf = torch.bfloat16
    t_all = time.time()
    config = get_preset("celeb256_dit")

    # 1. build, in a thread, while the DiT-L/2 of the main path is made and
    # saved as the model_0.pth that the train phase starts from
    built = {}

    def build():
        t = time.time()
        try:
            built["lib"] = _build.build()
        except BaseException as e:  # raised again below, in the main thread
            built["error"] = e
        built["seconds"] = time.time() - t

    builder = threading.Thread(target=build)
    builder.start()
    model = create_network(config.model, dtype=bf, use_flash=config.model.use_flash_attention,
                           device=dev)
    seeded_init_(model, SEED)
    ckpt_path = os.path.join(work, "model_0.pth")
    torch.save({"pos_embed": model.pos_embed.cpu(),
                **{k: v.cpu() for k, v in model.state_dict().items()}}, ckpt_path)
    probe = "blocks.0.attn.qkv.weight"
    p0 = dict(model.named_parameters())[probe].detach().clone()
    builder.join()
    if "error" in built:
        raise built["error"]
    _build.load_library()
    emit({"phase": "build", "seconds": built["seconds"], "until_joined": time.time() - t_all,
          "lib": os.path.relpath(built["lib"])})

    # 2. kernels against their plain versions
    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rn(*shape, scale=1.0, dtype=bf):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(dtype)

    batch = config.sample.batch_size
    train_batch = config.train.batch_size
    k1_rows, k2_rows, k3_rows = {}, {}, {}
    k1_cases = sorted({(8, 256, 16, 64, bf), (2, 1024, 16, 64, bf), (train_batch, 256, 16, 64, bf),
                       (batch, 256, 16, 64, bf)}, key=lambda c: c[:4])
    for n, t, h, d, dt in k1_cases + [(8, 256, 16, 64, torch.float32)]:
        t_case = time.time()
        q, k, v = rn(n, t, h, d, dtype=dt), rn(n, t, h, d, dtype=dt), rn(n, t, h, d, dtype=dt)
        out = attention_small(q, k, v)
        ref = reference_attention(q, k, v)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        tol = K1_TOL if dt == bf else F32_TOL
        if not rel <= tol:
            raise AssertionError(f"attention_small {(n, t, h, d, dt)}: max abs err {err} is {rel} "
                                 f"of max |plain| > {tol}")
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        esize = q.element_size()
        bms, by = bound_ms(4 * n * t * h * d * esize, 4 * n * h * t * t * d,
                           BF16_FLOPS if dt == bf else F32_FLOPS)
        row = {"shape": [n, t, h, d], "dtype": str(dt), "max_abs_err": err, "rel_err": rel,
               "tol": tol, "ms": time_ms(torch, lambda: attention_small(q, k, v)),
               "plain_ms": time_ms(torch, lambda: reference_attention(q, k, v)),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh)),
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        k1_rows[(n, t, dt)] = row
        emit({"phase": "kernel", "name": "attention_small", **row})
        del q, k, v, qh, kh, vh, out, ref

    t, c, heads = 256, 1024, 16
    hid = 4 * c
    for n in sorted({8, batch}):
        t_case = time.time()
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
               "rel_err": rel, "tol": K2_TOL,
               "ms": time_ms(torch, lambda: fused_dit_block(**blk, num_heads=heads)),
               "plain_ms": time_ms(torch, lambda: reference_block(**blk, num_heads=heads)),
               "library_ms": time_ms(torch, lambda: library_block(F, **blk, num_heads=heads)),
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        k2_rows[n] = row
        emit({"phase": "kernel", "name": "fused_dit_block", **row})
        del blk, out, ref

    for n, t, h, d, dt in ((train_batch, 256, 16, 64, bf), (8, 1024, 16, 64, bf),
                           (8, 256, 16, 64, torch.float32)):
        t_case = time.time()
        q, k, v, do = (rn(n, t, h, d, dtype=dt) for _ in range(4))
        got = attention_small_bwd(q, k, v, do)
        want = reference_attention_bwd(q, k, v, do)
        torch.cuda.synchronize()
        tol = K3_TOL if dt == bf else F32_TOL
        errs = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            errs[name] = rel_err(g, w)
            if not errs[name][1] <= tol:
                raise AssertionError(f"attention_small_bwd {(n, t, h, d, dt)} {name}: max abs err "
                                     f"{errs[name][0]} is {errs[name][1]} of max |plain| > {tol}")
        qh, kh, vh = (a.transpose(1, 2).contiguous().requires_grad_(True) for a in (q, k, v))
        doh = do.transpose(1, 2).contiguous()
        oh = F.scaled_dot_product_attention(qh, kh, vh)

        def sdpa_bwd():
            torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)

        bms, by = bound_ms(7 * n * t * h * d * q.element_size(), 10 * n * h * t * t * d,
                           BF16_FLOPS if dt == bf else F32_FLOPS)
        row = {"shape": [n, t, h, d], "dtype": str(dt),
               "max_abs_err": max(e[0] for e in errs.values()),
               "rel_err": {name: e[1] for name, e in errs.items()}, "tol": tol,
               "ms": time_ms(torch, lambda: attention_small_bwd(q, k, v, do)),
               "plain_ms": time_ms(torch, lambda: reference_attention_bwd(q, k, v, do)),
               "library_ms": time_ms(torch, sdpa_bwd),
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        k3_rows[(n, t, dt)] = row
        emit({"phase": "kernel", "name": "attention_small_bwd", **row})
        del q, k, v, do, got, want, qh, kh, vh, doh, oh
    emit({"phase": "kernels_vs_plain", "seconds": time.time() - t0})

    # 3. gradients of a small full-width DiT through K1/K3 against plain autograd
    t0 = time.time()
    grads = []
    for use_flash in (True, False):
        small = DiT(img_resolution=32, patch_size=2, hidden_size=1024, depth=2, num_heads=16,
                    dtype=bf, use_flash=use_flash).to(dev)
        seeded_init_(small, SEED)
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 2)
        z0, z1 = (torch.randn(8, 32, 32, 4, generator=g, device=dev) for _ in range(2))
        tt = torch.rand(8, generator=g, device=dev)
        z_t, u = interpolate(z0, z1, tt)
        torch.mean(torch.square(small(tt, z_t, train=True) - u)).backward()
        grads.append({name: p.grad.float() for name, p in small.named_parameters()})
        del small
    worst = max(((rel_err(grads[0][name], want)[1], name) for name, want in grads[1].items()))
    emit({"phase": "grad", "tensors": len(grads[1]), "max_rel_err": worst[0], "tensor": worst[1],
          "tol": GRAD_TOL, "seconds": time.time() - t0})
    if not worst[0] <= GRAD_TOL:
        raise AssertionError(f"DiT gradient of {worst[1]} through K1/K3: {worst[0]} > {GRAD_TOL}")
    del grads

    # 4. main path, fused blocks: celeb256_dit, bf16 DiT-L/2, dopri5, VAE decode
    vae = create_vae(dtype=bf, device=dev)
    seeded_init_(vae, SEED + 1)
    depth = model.depth
    noise, y = noise_and_labels(config, SampleRNG(config.sample.seed), range(batch),
                                device=dev)
    sampler = make_sampler(config, model, None, vae, None, device=dev)
    ATTENTION_SMALL.count = FUSED_DIT_BLOCK.count = ATTENTION_SMALL_BWD.count = 0
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

    # 5. main path, module blocks: attention through attention_small
    mconfig = dataclasses.replace(config, sample=dataclasses.replace(
        config.sample, use_fused_dit=False, method="euler", num_steps=4))
    msampler = make_sampler(mconfig, model, None, vae, None, device=dev)
    ATTENTION_SMALL.count = FUSED_DIT_BLOCK.count = ATTENTION_SMALL_BWD.count = 0
    torch.cuda.synchronize()
    t0 = time.time()
    mres = msampler(noise, y)
    torch.cuda.synchronize()
    msecs = time.time() - t0
    k1_module, k2_in_module = ATTENTION_SMALL.count, FUSED_DIT_BLOCK.count
    mimg = mres.images
    with torch.no_grad():
        tt = torch.full((batch,), 0.5, device=dev)
        v_fused = dit_fused_apply(model, cast_params_bf16(model.state_dict()), tt, noise)
        v_module = model(tt, noise)
    vel_err = float((v_fused - v_module).abs().max()) / float(v_module.abs().max())
    emit({"phase": "main_module", "seconds": msecs, "method": "euler", "nfe": mres.nfe,
          "images": list(mimg.shape), "attention_small_launches": k1_module,
          "fused_dit_block_launches": k2_in_module, "velocity_rel_err": vel_err,
          "velocity_tol": VEL_TOL})
    if not (bool(torch.isfinite(mimg).all()) and tuple(mimg.shape) == tuple(img.shape)):
        raise AssertionError("module path images are not finite or have the wrong shape")
    if k1_module != depth * mres.nfe or k2_in_module != 0:
        raise AssertionError(f"module path: {k1_module} attention_small launches for NFE "
                             f"{mres.nfe} x depth {depth}; {k2_in_module} fused_dit_block")
    if not vel_err <= VEL_TOL:
        raise AssertionError(f"fused vs module velocity: {vel_err} > {VEL_TOL}")
    del sampler, msampler, res, mres, img, mimg, noise, v_fused, v_module

    # 6. train: celeb256_dit through train(...), from the seeded weights above
    t_train = time.time()
    del model
    torch.cuda.empty_cache()
    tc = dataclasses.replace(config.train, model_ckpt=ckpt_path)
    tconfig = dataclasses.replace(config, train=tc, output_dir=work)
    dataset = SyntheticImageDataset(n=train_batch * (TRAIN_STEPS + 2), image_size=256,
                                    seed=SEED)
    if TRAIN_STEPS >= len(dataset) // train_batch:
        raise AssertionError("the train run must stay below one epoch (no demo plot)")

    def train_run(max_steps):
        logs = []
        ATTENTION_SMALL.count = FUSED_DIT_BLOCK.count = ATTENTION_SMALL_BWD.count = 0
        torch.cuda.reset_peak_memory_stats()
        t_run = time.time()
        state = train(tconfig, dataset=dataset, vae=vae, device=dev, max_steps=max_steps,
                      log_fn=lambda line: logs.append((time.time(), line)))
        torch.cuda.synchronize()
        t_end = time.time()
        steps = [(t, line) for t, line in logs if "Loss: " in line]
        if len(steps) != 1:
            raise AssertionError(f"train: expected one log line, after step 1; got {steps}")
        loss = float(re.search(r"Loss: (\S+),", steps[0][1]).group(1))
        return state, loss, steps[0], t_end, t_end - t_run

    state1, loss1, _, _, run1_s = train_run(1)
    i = state1.names.index(probe)
    p1, ema1 = state1.params[i].detach(), state1.ema[i].detach()
    decay = tc.ema_decay
    ema_err = float((ema1 - (decay * p0 + (1 - decay) * p1)).abs().max())
    moved = float((p1 - p0).abs().max())
    del state1, p1, ema1
    torch.cuda.empty_cache()
    state, loss_again, (t_log, line), t_end, run_s = train_run(TRAIN_STEPS)
    k1_train, k3_train, k2_train = (ATTENTION_SMALL.count, ATTENTION_SMALL_BWD.count,
                                    FUSED_DIT_BLOCK.count)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tdepth = len([name for name in state.names if name.endswith("attn.qkv.weight")])
    finite = all(bool(torch.isfinite(p).all()) for p in state.params)
    sec_per_step = (t_end - t_log) / (TRAIN_STEPS - 1)
    emit({"phase": "train", "preset": "celeb256_dit", "model": config.model.model_type,
          "batch": train_batch, "steps": state.step, "seconds_per_step": sec_per_step,
          "images_per_s": train_batch / sec_per_step, "peak_gib": peak,
          "loss_step1": loss1, "loss_step1_again": loss_again, "log": line,
          "run_seconds": [run1_s, run_s], "attention_small_launches": k1_train,
          "attention_small_bwd_launches": k3_train, "fused_dit_block_launches": k2_train,
          "ema_max_abs_err": ema_err, "param_max_change_step1": moved,
          "params_finite": finite, "seconds": time.time() - t_train})
    if not (math.isfinite(loss1) and math.isfinite(loss_again) and finite):
        raise AssertionError(f"train: step 1's loss {loss1}, {loss_again} or the parameters "
                             "are not finite")
    if not moved > 0:
        raise AssertionError("train: the parameters did not move in one step")
    if not ema_err <= 1e-6 * float(p0.abs().max()):
        raise AssertionError(f"train: EMA is off decay * p0 + (1 - decay) * p1 by {ema_err}")
    if (state.step != TRAIN_STEPS or k3_train != tdepth * TRAIN_STEPS
            or k1_train != 2 * tdepth * TRAIN_STEPS or k2_train != 0):
        raise AssertionError(f"train: {state.step} steps, {k3_train} attention_small_bwd and "
                             f"{k1_train} attention_small launches for depth {tdepth}")
    del state

    # 7. the kernels line, the card, the last line
    k1 = k1_rows[(train_batch, 256, bf)]
    k2_row = k2_rows[batch]
    k3 = k3_rows[(train_batch, 256, bf)]
    emit({"kernels": [
        {"name": "attention_small", "route": "cuda",
         "source": "lfm_tpu_torch/kernels/csrc/attention.cuh",
         "replaces": "lfm_tpu/kernels/flash_attention.py:163", "launches": k1_train,
         "launches_by_path": {"main_module": k1_module, "train": k1_train},
         "shape": k1["shape"], "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"]},
        {"name": "fused_dit_block", "route": "cuda",
         "source": "lfm_tpu_torch/kernels/csrc/dit_block.cu",
         "replaces": "lfm_tpu/kernels/dit_block.py:135", "launches": k2_launches,
         "launches_by_path": {"main_fused": k2_launches, "train": k2_train},
         "shape": k2_row["shape"], "max_abs_err": k2_row["max_abs_err"], "ms": k2_row["ms"],
         "plain_ms": k2_row["plain_ms"], "bound_ms": k2_row["bound_ms"],
         "bound_by": k2_row["bound_by"], "library_ms": k2_row["library_ms"]},
        {"name": "attention_small_bwd", "route": "cuda",
         "source": "lfm_tpu_torch/kernels/csrc/attention_bwd.cuh",
         "replaces": "lfm_tpu/kernels/flash_attention.py:233", "launches": k3_train,
         "launches_by_path": {"train": k3_train},
         "shape": k3["shape"], "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": k3["library_ms"]},
    ], "seconds_total": time.time() - t_all})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
