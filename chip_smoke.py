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
     (32, 256, 16, 64) (the train step's shape), (8, 256, 16, 72) (DiT-XL's
     head) and (N, 256, 16, 64), the last also on the thirds of a fused qkv
     row (K2's layout), and f32 at the f32 DiT's heads, (8, 256, 16, 64),
     (32, 256, 16, 64) (train_f32's shape) and (8, 256, 16, 72), past T =
     256 (attention_long_f32.cuh's key-block kernel, the whole row one
     block) at (2, 1024, 16, 64) (an f32 DiT-L/2 at 512 px, the long_f32
     path's shape), (2, 512, 16, 64), (2, 300, 16, 64) and (2, 1024, 16,
     72), and at the origin ADM's heads, (N, 16, 4, 128) (celeb256_adm's
     path), (16, 64, 4, 128), (16, 16, 4, 256) and (16, 256, 4, 128)
     (attention.cuh's kernel); library: scaled_dot_product_attention;
   - fused_dit_block (K2) at T=256, C=1024, hidden 4096, 16 heads, N=8 and
     N, every weight non-zero; library: the same block composed of cuBLAS
     bf16 matmuls and scaled_dot_product_attention;
   - attention_small_bwd (K3), bf16 at (32, 256, 16, 64) and
     (8, 1024, 16, 64), f32 at (8, 256, 16, 64), (32, 256, 16, 64),
     (8, 256, 16, 72) and (2, 1024, 16, 64) (past T = 256: the dq kernel of
     attention_long_f32.cuh); library: the backward of scaled_dot_product_attention
     through autograd (its saved forward graph, backward alone);
   - flash_attention (K4), bf16 at (2, 4096, 16, 64) (DiT-L/2 at 1024 px,
     the long_t path) and (4, 2048, 16, 64), f32 at (1, 4096, 4, 128) and
     (2, 4096, 16, 64) (an f32 DiT-L/2 at 1024 px);
     library: scaled_dot_product_attention;
   - groupnorm_silu (K6), bf16 at (N, 32, 32, 256), (N, 32, 32, 768) (the
     largest in-norm input of celeb256_adm), (N, 4, 4, 1024) and
     (N, 32, 32, 256) offset by +8, f32 at (8, 32, 32, 256); library:
     silu(group_norm) on an f32 channels-last view;
   - K5, the differentiable fused block, at the train step's batch (32) and
     at 8, T=256, C=1024, hidden 4096, 16 heads, every weight non-zero:
     block_train_fwd with full and slim streams (library: the block
     composed as for K2, its streams kept), mlp_bwd and attn_bwd on the
     kernel forward's own streams (library: autograd's backward of the same
     half composed of cuBLAS, layer_norm and SDPA, backward alone); mlp_bwd
     gives a digest of its outputs and fails unless a second call on the
     same inputs gives the same bits. Then
     one block-level check at N = 8: make_fused_block_train with the hybrid
     backward (path block_hybrid) and with pallas_bwd (path
     block_pallas_bwd), each against autograd through reference_block, all
     10 cotangents, with the launch counts of each.
   - P1, the int8 GEMM (int8_gemm_sm90.cuh, s8 wgmma + TMA) and the row
     quantization (int8_gemm.cu): quant_rows at fc2's input, (51200,
     4096) f32 (no single library call computes it: library_ms null);
     int8_dense at the int8 path's four products, M = 51200 (N = 200 x T
     = 256) with (K, N) = (1024, 3072) to bf16 (qkv), (1024, 1024) (proj),
     (1024, 4096) + GELU (fc1) and (4096, 1024) (fc2), f32 out, library:
     torch._int_mm (cuBLASLt) with eager quantization and dequantization;
     int8_mlp and bf16_mlp at P1's own call, 16384 rows, D 1024, H 4096,
     CHAIN 8 (tools/microbench_int8.py's inputs), library: the _int_mm
     chain and F.linear + gelu in bf16.
   N is the preset's sampling batch (200), the sampling path's batch.
   Then one attention_redesign line: each shape of the redesigned
   attention kernels (bf16 K1 and K4, the wgmma + TMA forward of
   attention_sm90.cuh; bf16 K3, the wgmma + TMA backward of
   attention_bwd_sm90.cuh; f32 K1 at the origin ADM's T <= 64, the one-pass
   kernel of attention_wide.cu; f32 K1 and K3 at the DiT's heads and T <=
   256, the one-pass kernels of attention_row_f32.cuh; f32 K4, K1 and K3
   past T = 256, the key-block and whole-row kernels of
   attention_long_f32.cuh; beside them f32 K1 at the ADM's D = 128 past T
   = 64, attention.cuh's) with its ms, share of its bound, ratio to SDPA
   and output digest, and the registers and spills of each of the 12
   wgmma kernel instances, the 14 instances of attention_row_f32.cuh and
   the 9 of attention_long_f32.cuh from the build's ptxas report; a spill
   fails the run. And one gemm_redesign line: each NT GEMM of K2 at N and
   of K5's forward at the train batch, and each NN and TN GEMM of K5's MLP
   backward at the train batch, alone (the persistent wgmma + TMA GEMM of
   gemm_sm90.cuh, through kernels/gemm.py; tools/bench_block.py's
   gemm_rows and mlp_gemm_rows) with its ms, TFLOP/s, share of its bound,
   tile width (and, for the MLP backward's, CTAs and splits of K) and
   torch.matmul's time for the same product, and the registers and spills
   of its 14 instances; a spill fails the run. And one int8_redesign line: P1's int8 GEMM alone at the
   int8 path's four products (M = 51200) and the probe step's two
   (tools/bench_int8.py's gemm_rows) with its ms, TOP/s, share of its
   bound, tile width and schedule, int8_dense's and torch._int_mm's times
   for the same int32 product, and the output's digest; it fails unless
   the output equals the plain version's and int8_dense's bit for bit, and
   on a spill in any of its 8 instances.
3. grad: a 2-block DiT at DiT-L width (C = 1024, 16 heads, T = 256), batch
   8, bf16 compute on f32 masters; the flow-matching loss's parameter
   gradients with attention through K1/K3, and through
   dit_fused_apply(train_vjp=True) (K5's forward, the hybrid backward
   through K3), each against plain autograd of reference_attention, per
   tensor. Then the same model in f32 (f32 compute, as train_f32): its
   gradients through f32 K1/K3 against plain autograd in f32, per tensor.
4. main_fused: ``make_sampler`` on the celeb256_dit preset, a bf16 DiT-L/2
   at full width and depth with seeded non-zero weights, dopri5 at the
   preset's tolerances, full-size VAE decode of N samples to
   (N, 256, 256, 3); fused_dit_block must launch 24 x NFE times.
5. main_module: the same model with use_fused_dit=False, euler at 4 steps;
   attention_small must launch 24 x NFE times. The fused and module
   velocities at one (t, x) must agree.
5b. int8_main: the same model and noise with use_int8_dit=True (w8a8, the
   weights quantized once when the sampler is built), euler at 4 steps,
   VAE decode; quant_rows and int8_dense must each launch 4 x 24 x NFE
   times and nothing else (no K1, no K2). The int8 velocity at one (t, x)
   must agree with the plain int8 path on the card, and with main_module's
   bf16 velocity within the JAX package's 8%.
5c. fid: FIDInceptionV3 with seeded weights (eval/inception.py) on the
   card over main_module's and int8_main's 200 images; its activations on
   2 images against the same module on the CPU; the Fréchet distance
   int8-vs-bf16 must be finite. With seeded weights it is a protocol-level
   number, not an image-quality one.
5d. p1_probe: tools/microbench_int8.py's measure() (P1's probe: int8_mlp
   against bf16_mlp, each chained 8 times per call); int8_mlp and bf16_mlp
   must each launch 8 x (1 + REPS) times and nothing else.
6. adm_main: ``make_sampler`` on the celeb256_adm preset, a bf16 origin-ADM
   UNet at full width (nf 256, ch_mult 1 2 2 2, 2 ResBlocks per level, 4
   heads, attention through K1) with seeded non-zero weights, dopri5 at
   the preset's tolerances, full-size VAE decode of N samples;
   attention_small must launch (attention layers) x NFE times and
   groupnorm_silu never, both counts from ``build_unet_plan``.
7. adm_fused_gn: the same weights with use_fused_gn, euler at 4 steps;
   groupnorm_silu must launch (ResBlocks) x 4 times, and the velocity at
   one (t, x) must agree with the unfused model's.
8. long_t: ``make_sampler`` on celeb256_dit at image_size 1024 (DiT-L/2 at
   full width and depth, T = 4096 tokens, past the fused block's gate),
   euler at 2 steps, batch 2, VAE decode to 1024^2; flash_attention must
   launch 24 x 2 times and attention_small never.
8b. long_f32: ``make_sampler`` on celeb256_dit at image_size 512 in f32
   (an f32 DiT-L/2 at full width and depth from the same weights, T = 1024
   tokens: f32 K1 past T = 256, attention_long_f32.cuh's key-block kernel
   with its whole row one block), euler at 2 steps, batch 2, VAE decode to
   512^2; attention_small must launch 24 x 2 times, all f32, and nothing
   else; the velocity at one (t, x) must agree with the same f32 model's
   with plain attention within F32_VEL_TOL.
9. train: ``train(...)`` on the celeb256_dit preset (DiT-L/2 at full width
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
10. train_fused: the same train step (the same model_0.pth, VAE encoder,
   batches, draws, AdamW + EMA) through make_train_step(model_apply=
   dit_fused_model_apply(model)), whose blocks are K5's forward and the
   hybrid backward through K3, for 1 + TRAIN_STEPS steps: step 1's loss
   against the train phase's step 1 (the same batch and draws) within 2%,
   the EMA after step 1, and launch counts of exactly 24 block_train_fwd
   and 24 attention_small_bwd per step and nothing else; the time of steps
   2 to 1 + TRAIN_STEPS, after a sync, is the seconds per step.
10b. train_f32: ``train(...)`` on the same preset, model_0.pth, VAE encoder
   and images with precision="f32" (f32 compute on f32 masters, grad
   checkpointing and EMA as the preset sets them), 1 + TRAIN_F32_STEPS
   steps (tools/bench_train.py's timed_train: the time from the log after
   step 1 to the end, after a sync, over TRAIN_F32_STEPS is the seconds
   per step): exactly 2 x 24 f32 attention_small (forward and recompute)
   and 24 f32 attention_small_bwd per step and no other kernel, f32
   parameters that stay finite, and step 1's loss within F32_LOSS_TOL of
   the same f32 model's with plain attention (use_flash_attention=False)
   on the same batch and draws, while the same plain step with attention's
   products in TF32 lands outside it.
11. a ``kernels`` line with every ported kernel (f32 K1 at celeb256_adm's
   (200, 16, 4, 128) as its own entry, attention_small_f32, with
   adm_main's launches; f32 K1 and K3 at the f32 DiT's (32, 256, 16, 64)
   as attention_small_f32_dit and attention_small_bwd_f32, with
   train_f32's; f32 K1 at (2, 1024, 16, 64) as attention_small_f32_long,
   with long_f32's), each with its source files, then the card's name and
   power limit, then the last line ``{"ok": true, "device": {...}}``.

Every path resets all launch counts just before it runs and reads them
just after.

Any failed check raises, so the exit code is not 0. Without CUDA, or
without the package beside it, the script exits non-zero before printing
any result.
"""

from __future__ import annotations

import dataclasses
import hashlib
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
# K4: max abs error / max |plain| in bf16, as K1 (its plain version takes
# the same key blocks)
K4_TOL = 2e-2
# K6: max abs error / max |plain| in bf16: one rounding of the output on
# both sides, which may fall the other way after f32 sums in another order
K6_TOL = 2e-2
# f32 kernels (K1, K3, K4, K6): f32 sums in another order
F32_TOL = 1e-4
# fused vs module velocity (DiT), fused vs plain GroupNorm + SiLU (ADM):
# max abs / max |reference| (as tests/test_dit_fused.py)
VEL_TOL = 5e-2
# DiT parameter gradients through K1/K3, and through dit_fused_apply(
# train_vjp=True), vs plain autograd: max abs error / max |plain| per
# tensor, the bf16 tolerance of the CPU parity tests (for the fused path
# tighter than the JAX package's own 8e-2, tests/test_dit_fused.py:190: the
# card reads 0.6-0.7% for both)
GRAD_TOL = 5e-2
# long_f32's f32 velocity through f32 K1 against the same f32 DiT-L/2 with
# plain attention: max abs / max |plain|, f32 sums in another order carried
# through 24 blocks (as F32_TOL for one kernel)
F32_VEL_TOL = 1e-4
# the same in f32 through f32 K1/K3: f32 sums in another order, carried
# through two blocks of the backward (tests/test_torch_cuda.py's f32 case;
# the card reads 3.8e-7)
F32_GRAD_TOL = 1e-5
# train_f32's step-1 loss against the same f32 model's with plain attention
# on the same batch and draws, relative: set between the readings of the
# card (NVIDIA H100 80GB HBM3), 0.0 with the f32 kernels and 8.0e-7 (8 f32
# ulps of a loss of 2.39) with the plain attention's products in TF32; the
# phase also checks that the TF32 reading stays above it
F32_LOSS_TOL = 4e-7
# K5 against its plain versions: max abs error / max |plain| per output,
# bf16 streams and f32 sums of bf16 products at the same rounding points (a
# rounding that falls the other way moves a term by 2^-8); out and x1 (and
# dx1, dx) against the block's update |plain - x| (|plain - dy|, |plain -
# dx1|), as K2, so that the residual cannot hide a wrong update, with one
# bf16 ulp of the largest output allowed on top (the output's own rounding)
K5_TOL = 2e-2
BF16_ULP = 2.0 ** -7  # the largest spacing of bf16 values, relative
# make_fused_block_train's 10 cotangents vs autograd through reference_block,
# which keeps in f32 what the kernels round to bf16 (dh2, dpr, do, dqkv):
# the bf16 tolerance of the CPU gradient tests
BLOCK_GRAD_TOL = 5e-2
# the fused train step's loss vs the module step's: the JAX package's own
# tolerance for its fused path against its module path
# (tests/test_dit_fused.py:180)
FUSED_LOSS_TOL = 2e-2
# P1: quant_rows bit-exact (the same IEEE divisions and ties to even);
# int8_dense, one product, max abs error / max |plain| within 1e-5 (exact
# int32 sums, the same f32 dequant; GELU's tanh may differ in the last bit);
# bf16 out within one rounding of it. int8_mlp, one step of P1's call,
# within 2e-2: a GELU output that differs in its last bit can land on the
# other side of a rounding boundary of the hidden's quantization, and one
# int8 step of one hidden value moves an output by up to ~1e-2 of the
# largest. After P1's chain of 8, within 0.15: the chain amplifies such
# flips; giving the plain chain's GELU last-bit changes alone (f64 GELU
# rounded to f32) moves its output by 8.4% of its largest at P1's scales,
# 3.3% at scales that hold the chain's size (512 rows on the CPU).
# bf16_mlp, one step and the chain of 8, within 2e-2: f32 sums in another
# order round to bf16 the other way (0.8% after the chain, the same test)
INT8_TOL = 1e-5
P1_STEP_TOL = 2e-2
P1_CHAIN_TOL = 0.15
BF16_MLP_TOL = 2e-2
# the int8 velocity against the plain int8 path on the card: the GELU's
# last-bit differences flip a few quantizations a block, 24 blocks deep
INT8_VEL_TOL = 1e-2
# the int8 velocity against the bf16 module's: the JAX package's own
# bound for its int8 path (tests/test_dit_int8.py:62)
INT8_VS_BF16_TOL = 8e-2
# Inception pool3 on the card against the same module on the CPU, f32 with
# TF32 off: max abs / max |CPU|, f32 convolutions in other algorithms over
# 95 layers
FID_ACT_TOL = 1e-3
INT8_OPS = 1979e12  # dense int8 tensor-core op/s, H100 SXM data sheet
P1_ROWS = 51200  # the int8 path's rows at the sampling batch: 200 x 256 tokens
TRAIN_STEPS = 12  # the first step is not timed
TRAIN_F32_STEPS = 6  # timed steps of train_f32, after its first
ADM_FUSED_STEPS = 4  # euler steps of the adm_fused_gn path
LONG_T_SIZE = 1024  # image size of the long_t path: T = (1024 / 8 / 2)^2 = 4096
LONG_F32_SIZE = 512  # image size of the long_f32 path: T = (512 / 8 / 2)^2 = 1024


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


def digest(torch, *tensors) -> str:
    """A digest of the tensors' bytes: equal outputs, equal digests."""
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def rel_err(a, b):
    err = float((a.float() - b.float()).abs().max())
    return err, err / float(b.float().abs().max())


def library_attn_half(F, x, mod, wqkv, bqkv, wproj, bproj, *, num_heads):
    """The block's attention half from library calls (cuBLAS bf16 matmuls,
    layer_norm, scaled_dot_product_attention): (x1, pr, qkv, ao). A
    yardstick of speed only, as are the two below."""
    n, t, c = x.shape
    m = mod.reshape(n, 6, 1, c)
    h = F.layer_norm(x, (c,), eps=1e-6) * (1 + m[:, 1]) + m[:, 0]
    qkv = F.linear(h, wqkv, bqkv)
    q, k, v = qkv.view(n, t, 3, num_heads, c // num_heads).permute(2, 0, 3, 1, 4)
    ao = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(n, t, c)
    pr = F.linear(ao, wproj, bproj)
    return x + m[:, 2] * pr, pr, qkv, ao


def library_mlp_half(F, x1, mod, w1, b1, w2, b2):
    """The block's MLP half from library calls: (out, h2, u)."""
    n, t, c = x1.shape
    m = mod.reshape(n, 6, 1, c)
    h = F.layer_norm(x1, (c,), eps=1e-6) * (1 + m[:, 4]) + m[:, 3]
    u = F.linear(h, w1, b1)
    h2 = F.linear(F.gelu(u, approximate="tanh"), w2, b2)
    return x1 + m[:, 5] * h2, h2, u


def library_block_streams(F, x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2, *, num_heads):
    """K2's block from library calls, with the streams K5's forward writes:
    (out, x1, h2, pr, qkv, ao, u)."""
    x1, pr, qkv, ao = library_attn_half(F, x, mod, wqkv, bqkv, wproj, bproj,
                                        num_heads=num_heads)
    out, h2, u = library_mlp_half(F, x1, mod, w1, b1, w2, b2)
    return out, x1, h2, pr, qkv, ao, u


def library_block(F, **kwargs):
    return library_block_streams(F, **kwargs)[0]


def library_int8_dense(torch, F, x, q_w, s_w, bias, gelu, out_dtype):
    """int8_dense from library calls: eager row quantization, torch._int_mm
    (cuBLASLt), eager dequant. A yardstick of speed only."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(xf / s).clamp_(-127, 127).to(torch.int8)
    y = torch._int_mm(q, q_w.t()).float() * s * s_w
    if bias is not None:
        y = y + bias.float()
    return (F.gelu(y, approximate="tanh") if gelu else y).to(out_dtype)


def library_int8_mlp(torch, F, x, q1, s1, b1, q2, s2, b2):
    h = library_int8_dense(torch, F, x, q1, s1, b1, True, torch.float32)
    return library_int8_dense(torch, F, h, q2, s2, b2, False, torch.float32)


def library_bf16_mlp(F, x, w1, w2):
    return F.linear(F.gelu(F.linear(x, w1), approximate="tanh"), w2)


def backward_only(torch, fn, inputs, cotangent):
    """A closure running autograd's backward of ``fn(*inputs)`` alone (its
    forward graph built once and kept)."""
    leaves = [a.detach().requires_grad_(True) for a in inputs]
    out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, cotangent, retain_graph=True)


def output_errors(names, got, want, updates=None):
    """{name: (max abs error, relative error, reference, ulp)}: the reference
    is max |plain - base| where ``updates`` names a base tensor, and then ulp
    is one bf16 ulp of max |plain|; else max |plain|, ulp 0."""
    errs = {}
    for name, g, w in zip(names, got, want):
        err = float((g.float() - w.float()).abs().max())
        base = (updates or {}).get(name)
        ref = float(((w.float() - base.float()) if base is not None else w.float()).abs().max())
        ulp = BF16_ULP * float(w.float().abs().max()) if base is not None else 0.0
        errs[name] = (err, err / ref, ref, ulp)
    return errs


def check_errors(what, errs, tol):
    for name, (err, rel, ref, ulp) in errs.items():
        if not err <= tol * ref + ulp:
            raise AssertionError(f"{what} {name}: max abs err {err} is {rel} of its reference "
                                 f"{ref} > {tol} (+ one bf16 ulp, {ulp})")


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

    from lfm_tpu_torch.core.checkpoint import reference_state_dict
    from lfm_tpu_torch.core.config import get_preset
    from lfm_tpu_torch.core.rng import SampleRNG
    from lfm_tpu_torch.data import DataLoader, SyntheticImageDataset
    from lfm_tpu_torch.kernels import _build
    from lfm_tpu_torch.kernels.dit_block import FUSED_DIT_BLOCK, fused_dit_block, reference_block
    from lfm_tpu_torch.kernels.dit_block_train import (ATTN_BWD, BLOCK_TRAIN_FWD, MLP_BWD,
                                                       attn_bwd, block_train_fwd,
                                                       make_fused_block_train, mlp_bwd,
                                                       reference_attn_bwd,
                                                       reference_block_fwd_streams,
                                                       reference_mlp_bwd)
    from lfm_tpu_torch.kernels.flash_attention import (ATTENTION_SMALL, ATTENTION_SMALL_BWD,
                                                       FLASH_ATTENTION, attention_small,
                                                       attention_small_bwd, flash_attention,
                                                       reference_attention,
                                                       reference_attention_bwd,
                                                       reference_flash_attention)
    from lfm_tpu_torch.kernels.groupnorm_silu import (GROUPNORM_SILU, groupnorm_silu,
                                                      reference_groupnorm_silu)
    from lfm_tpu_torch.kernels.int8_matmul import (BF16_MLP, INT8_DENSE, INT8_MLP, QUANT_ROWS,
                                                   bf16_mlp, int8_dense, int8_mlp, quant_rows,
                                                   reference_bf16_mlp, reference_int8_dense,
                                                   reference_int8_mlp, reference_quant_rows)
    from lfm_tpu_torch.eval.fid import (ActivationExtractor, activation_statistics,
                                        calculate_frechet_distance)
    from lfm_tpu_torch.eval.inception import seeded_inception_state_dict
    from lfm_tpu_torch.nn.dit_int8 import dit_int8_apply, quantize_params_int8, quantize_weight
    from lfm_tpu_torch.tools import bench_train, microbench_int8
    from lfm_tpu_torch.nn.adm_unet import plan_layers
    from lfm_tpu_torch.nn.dit import DiT
    from lfm_tpu_torch.nn.dit_fused import (cast_params_bf16, dit_fused_apply,
                                           dit_fused_model_apply)
    from lfm_tpu_torch.nn.factory import create_network
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.nn import layers as nn_layers
    from lfm_tpu_torch.ode.flow import interpolate
    from lfm_tpu_torch.sample.sample import make_sampler, noise_and_labels
    from lfm_tpu_torch.train.loop import train
    from lfm_tpu_torch.train.state import create_train_state, make_optimizer
    from lfm_tpu_torch.train.train import make_train_step
    from lfm_tpu_torch.vae.autoencoder_kl import create_vae

    dev = torch.device("cuda")
    bf, f32 = torch.bfloat16, torch.float32
    t_all = time.time()
    config = get_preset("celeb256_dit")
    counters = {"attention_small": ATTENTION_SMALL, "fused_dit_block": FUSED_DIT_BLOCK,
                "attention_small_bwd": ATTENTION_SMALL_BWD, "flash_attention": FLASH_ATTENTION,
                "groupnorm_silu": GROUPNORM_SILU, "dit_block_train_fwd": BLOCK_TRAIN_FWD,
                "dit_block_train_mlp_bwd": MLP_BWD, "dit_block_train_attn_bwd": ATTN_BWD,
                "quant_rows": QUANT_ROWS, "int8_dense": INT8_DENSE, "int8_mlp": INT8_MLP,
                "bf16_mlp": BF16_MLP}

    def reset_counts():
        for c in counters.values():
            c.reset()

    def counts():
        return {name: c.count for name, c in counters.items()}

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
    k1_rows, k2_rows, k3_rows, k4_rows, k6_rows = {}, {}, {}, {}, {}
    k1_cases = sorted({(8, 256, 16, 64, bf), (2, 1024, 16, 64, bf), (train_batch, 256, 16, 64, bf),
                       (8, 256, 16, 72, bf), (batch, 256, 16, 64, bf)}, key=lambda c: c[:4])
    # f32: the DiT's heads (train_f32's shape among them), then the origin
    # ADM's (celeb256_adm's path first)
    f32_dit = [(8, 256, 16, 64), (train_batch, 256, 16, 64), (8, 256, 16, 72)]
    # and past T = 256, where f32 K1 takes attention_long_f32.cuh's key-block
    # kernel with its whole row one block (64 query rows up to T = 512, 32
    # past it) and f32 K3 its dq kernel: an f32 DiT-L/2 at 512 px (the
    # long_f32 path's shape), T = 512, ragged T (300) and DiT-XL/2's head
    f32_long = [(2, 1024, 16, 64)]
    f32_long_k1 = f32_long + [(2, 512, 16, 64), (2, 300, 16, 64), (2, 1024, 16, 72)]
    # then the origin ADM's heads (celeb256_adm's path first), and D = 128
    # past T = 64 (attention.cuh's kernel, a model override)
    k1_f32 = [c + (f32,) for c in f32_dit + f32_long_k1] + [
        (batch, 16, 4, 128, f32), (16, 64, 4, 128, f32), (16, 16, 4, 256, f32),
        (16, 256, 4, 128, f32)]
    # and K2's layout: q, k, v as the thirds of one (N, T, 3C) qkv row
    k1_qkv = [(batch, 256, 16, 64, bf)]
    for n, t, h, d, dt, layout in ([c + ("separate",) for c in k1_cases + k1_f32]
                                   + [c + ("qkv",) for c in k1_qkv]):
        t_case = time.time()
        if layout == "qkv":
            qkv = rn(n, t, 3 * h * d, dtype=dt)
            q, k, v = (a.view(n, t, h, d) for a in qkv.split(h * d, dim=-1))
        else:
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
        row = {"shape": [n, t, h, d], "dtype": str(dt), "layout": layout, "max_abs_err": err,
               "rel_err": rel, "tol": tol, "digest": digest(torch, out),
               "ms": time_ms(torch, lambda: attention_small(q, k, v)),
               "plain_ms": time_ms(torch, lambda: reference_attention(q, k, v)),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh)),
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        k1_rows[(n, t, h, d, dt) + ((layout,) if layout != "separate" else ())] = row
        emit({"phase": "kernel", "name": "attention_small", **row})
        del q, k, v, qh, kh, vh, out, ref

    t, c, heads = 256, 1024, 16
    hid = 4 * c

    def block_inputs(n):
        """A DiT-L/2 block's inputs for a batch of n, every weight non-zero."""
        return dict(x=rn(n, t, c), mod=rn(n, 6 * c, scale=0.3),
                    wqkv=rn(3 * c, c, scale=c ** -0.5), bqkv=rn(3 * c, scale=0.02),
                    wproj=rn(c, c, scale=c ** -0.5), bproj=rn(c, scale=0.02),
                    w1=rn(hid, c, scale=c ** -0.5), b1=rn(hid, scale=0.02),
                    w2=rn(c, hid, scale=hid ** -0.5), b2=rn(c, scale=0.02))

    for n in sorted({8, batch}):
        t_case = time.time()
        blk = block_inputs(n)
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

    for n, t, h, d, dt in ([(train_batch, 256, 16, 64, bf), (8, 1024, 16, 64, bf)]
                           + [c + (f32,) for c in f32_dit + f32_long]):
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
               "digest": digest(torch, *got),
               "ms": time_ms(torch, lambda: attention_small_bwd(q, k, v, do)),
               "plain_ms": time_ms(torch, lambda: reference_attention_bwd(q, k, v, do)),
               "library_ms": time_ms(torch, sdpa_bwd),
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        k3_rows[(n, t, d, dt)] = row
        emit({"phase": "kernel", "name": "attention_small_bwd", **row})
        del q, k, v, do, got, want, qh, kh, vh, doh, oh

    for n, t, h, d, dt in ((2, 4096, 16, 64, bf), (4, 2048, 16, 64, bf), (1, 4096, 4, 128, f32),
                           (2, 4096, 16, 64, f32)):
        t_case = time.time()
        q, k, v = (rn(n, t, h, d, dtype=dt) for _ in range(3))
        out = flash_attention(q, k, v)
        ref = reference_flash_attention(q, k, v)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        tol = K4_TOL if dt == bf else F32_TOL
        if not rel <= tol:
            raise AssertionError(f"flash_attention {(n, t, h, d, dt)}: max abs err {err} is {rel} "
                                 f"of max |plain| > {tol}")
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        bms, by = bound_ms(4 * n * t * h * d * q.element_size(), 4 * n * h * t * t * d,
                           BF16_FLOPS if dt == bf else F32_FLOPS)
        row = {"shape": [n, t, h, d], "dtype": str(dt), "max_abs_err": err, "rel_err": rel,
               "tol": tol, "ms": time_ms(torch, lambda: flash_attention(q, k, v)),
               "plain_ms": time_ms(torch, lambda: reference_flash_attention(q, k, v)),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh)),
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        k4_rows[(n, t, h, d, dt)] = row
        emit({"phase": "kernel", "name": "flash_attention", **row})
        del q, k, v, qh, kh, vh, out, ref

    # the redesigned attention kernels: the wgmma + TMA forward (bf16 K1 and
    # K4) and backward (bf16 K3), the one-pass f32 K1 at the origin ADM's
    # short sequences, the one-pass f32 K1 and K3 at the DiT's heads, and f32
    # K4, K1 and K3 past T = 256 (attention.cuh's f32 kernel, at the origin
    # ADM's D = 128 past T = 64, is listed beside them, not redesigned);
    # time against bound and SDPA at every shape above, and ptxas's
    # registers and spills of each instance
    csrc = "lfm_tpu_torch/kernels/csrc/"

    def f32_dit_row(r):
        return r["dtype"] == str(f32) and r["shape"][1] <= 256 and r["shape"][3] <= 80

    def f32_long_row(r):
        return r["dtype"] == str(f32) and r["shape"][1] > 256

    redesign = [{"kernel": name, "source": csrc + src, "shape": r["shape"], "dtype": r["dtype"],
                 "layout": r.get("layout", "separate"), "ms": r["ms"], "bound_ms": r["bound_ms"],
                 "bound_share": r["bound_ms"] / r["ms"], "library_ms": r["library_ms"],
                 "vs_sdpa": r["ms"] / r["library_ms"], "digest": r.get("digest")}
                for name, src, rows, pick in (
                    ("attention_small", "attention_sm90.cuh", k1_rows,
                     lambda r: r["dtype"] == str(bf)),
                    ("attention_small", "attention_wide.cu", k1_rows,
                     lambda r: r["dtype"] == str(f32) and r["shape"][1] <= 64
                     and r["shape"][3] >= 128),
                    ("attention_small", "attention_row_f32.cuh", k1_rows, f32_dit_row),
                    ("attention_small", "attention_long_f32.cuh", k1_rows, f32_long_row),
                    ("attention_small", "attention.cuh", k1_rows,
                     lambda r: r["dtype"] == str(f32) and r["shape"][1] > 64
                     and r["shape"][3] >= 128),
                    ("attention_small_bwd", "attention_bwd_sm90.cuh", k3_rows,
                     lambda r: r["dtype"] == str(bf)),
                    ("attention_small_bwd", "attention_row_f32.cuh", k3_rows, f32_dit_row),
                    ("attention_small_bwd", "attention_long_f32.cuh", k3_rows, f32_long_row),
                    ("flash_attention", "attention_sm90.cuh", k4_rows,
                     lambda r: r["dtype"] == str(bf)),
                    ("flash_attention", "attention_long_f32.cuh", k4_rows,
                     lambda r: r["dtype"] == str(f32)))
                for r in rows.values() if pick(r)]
    ptxas = {}
    flash = r"long32\d+(flash_f32_kernel)ILi(\d+)ELi(\d+)ELi(\d+)E"
    for stem, pattern in (("attention_sm90", r"(attn_\w+_kernel)ILi(\d+)ELb([01])E"),
                          ("attention_bwd", r"sm90\d+(attn_bwd_\w+_kernel)ILi(\d+)E"),
                          ("attention_row_f32", r"row32\d+(attn_row_kernel)ILi(\d+)ELi(\d+)E"),
                          ("attention_bwd_row_f32",
                           r"row32\d+(attn_row_bwd_\w+_kernel)ILi(\d+)E(?:Li(\d+)E)?"),
                          ("flash_attention_f32", flash), ("attention_long_f32", flash),
                          ("attention_bwd_long_f32",
                           r"long32\d+(attn_long_bwd_dq_kernel)ILi(\d+)ELi(\d+)E")):
        for mangled, use in _build.ptxas_usage(stem).items():
            m = re.search(pattern, mangled)
            if m:
                args = [{"1": "true", "0": "false"}.get(a, a) if stem == "attention_sm90" else a
                        for a in m.groups()[1:] if a]
                ptxas[f"{m.group(1)}<{', '.join(args)}>"] = use
    emit({"phase": "attention_redesign", "shapes": redesign, "ptxas": ptxas})
    spilled = {k: u for k, u in ptxas.items() if u.get("spill_stores") or u.get("spill_loads")}
    # wgmma: 8 forward instances (2 modes x 2 padded head dims x NORM_P), 4
    # of K3 (2 kernels x 2 padded head dims); f32 one-pass: 6 of K1 (2
    # padded head dims x TK 64, 128, 256), 6 of K3's dq kernel, 2 of its
    # dk/dv kernel; attention_long_f32.cuh: 3 of K4 (DP 64, 80, 128; f32 K1
    # takes those at DP 64, 80 up to T = 512), 2 of f32 K1 past T = 512 (DP
    # 64, 80 x 32 query rows, 1024 keys), 4 of K3's dq kernel past T = 256
    # (2 padded head dims x TK 512, 1024)
    if len(ptxas) != 35 or spilled:
        raise AssertionError(f"attention: {len(ptxas)} kernel instances, spills {spilled}")

    for n, hh, ww, c, dt, offset in ((batch, 32, 32, 256, bf, 0.0), (batch, 32, 32, 768, bf, 0.0),
                                     (batch, 4, 4, 1024, bf, 0.0), (batch, 32, 32, 256, bf, 8.0),
                                     (8, 32, 32, 256, f32, 0.0)):
        t_case = time.time()
        x = (rn(n, hh, ww, c, dtype=f32) + offset).to(dt)
        scale, bias = 1.0 + rn(c, scale=0.1, dtype=f32), rn(c, scale=0.1, dtype=f32)
        out = groupnorm_silu(x, scale, bias)
        ref = reference_groupnorm_silu(x, scale, bias)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        tol = K6_TOL if dt == bf else F32_TOL
        if not rel <= tol:
            raise AssertionError(f"groupnorm_silu {(n, hh, ww, c, dt, offset)}: max abs err {err} "
                                 f"is {rel} of max |plain| > {tol}")
        xl = x.float().permute(0, 3, 1, 2)  # f32, channels-last
        bms, by = bound_ms(2 * x.numel() * x.element_size() + 2 * c * 4, 10 * x.numel(),
                           F32_FLOPS)
        row = {"shape": [n, hh, ww, c], "dtype": str(dt), "offset": offset, "max_abs_err": err,
               "rel_err": rel, "tol": tol,
               "ms": time_ms(torch, lambda: groupnorm_silu(x, scale, bias)),
               "plain_ms": time_ms(torch, lambda: reference_groupnorm_silu(x, scale, bias)),
               "library_ms": time_ms(torch, lambda: F.silu(F.group_norm(xl, 32, scale, bias,
                                                                        1e-5))),
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        k6_rows[(n, hh, ww, c, dt, offset)] = row
        emit({"phase": "kernel", "name": "groupnorm_silu", **row})
        del x, xl, out, ref

    # K5: the forward with its streams, then each backward half on the
    # kernel forward's own streams (t and c as K2's; the loops above rebound
    # them)
    t, c = 256, 1024
    k5_rows = {}
    weights_bytes = 2 * (4 * c * c + 2 * c * hid + 5 * c + hid)
    stream_names = {"full": ("out", "x1", "h2", "pr", "qkv", "ao", "u"),
                    "slim": ("out", "h2", "pr", "qkv")}
    stream_width = {"full": 8 * c + hid, "slim": 6 * c}
    for n in sorted({8, train_batch}):
        blk = block_inputs(n)
        x, mod = blk["x"], blk["mod"]
        for mode in ("full", "slim"):
            t_case = time.time()
            got = block_train_fwd(**blk, num_heads=heads, save_streams=mode)
            want = reference_block_fwd_streams(**blk, num_heads=heads, save_streams=mode)
            torch.cuda.synchronize()
            errs = output_errors(stream_names[mode], got, want, {"out": x, "x1": x})
            check_errors(f"block_train_fwd {mode} N={n}", errs, K5_TOL)
            bms, by = bound_ms(weights_bytes + 2 * n * t * c + 2 * 6 * n * c
                               + 2 * n * t * stream_width[mode],
                               2 * n * t * c * (4 * c + 2 * hid) + 4 * n * t * t * c)
            row = {"shape": [n, t, c, hid, heads], "streams": mode,
                   "max_abs_err": max(e[0] for e in errs.values()),
                   "rel_err": {k: e[1] for k, e in errs.items()}, "tol": K5_TOL,
                   "ms": time_ms(torch, lambda: block_train_fwd(**blk, num_heads=heads,
                                                                save_streams=mode)),
                   "plain_ms": time_ms(torch, lambda: reference_block_fwd_streams(
                       **blk, num_heads=heads, save_streams=mode)),
                   "library_ms": time_ms(torch, lambda: library_block_streams(
                       F, **blk, num_heads=heads)),
                   "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
            k5_rows[("fwd", mode, n)] = row
            emit({"phase": "kernel", "name": "dit_block_train_fwd", **row})
            del got, want
        out, x1, h2, pr, qkv, ao, u = block_train_fwd(**blk, num_heads=heads)
        dy = rn(n, t, c)

        t_case = time.time()
        margs = (x1, mod, h2, u, blk["w1"], blk["w2"], dy)
        got = mlp_bwd(*margs)
        first = digest(torch, *got)
        again = digest(torch, *mlp_bwd(*margs))
        want = reference_mlp_bwd(*margs)
        torch.cuda.synchronize()
        if again != first:  # fixed-order sums, no atomics: the same bits each call
            raise AssertionError(f"mlp_bwd N={n}: two calls on the same inputs differ "
                                 f"({first} != {again})")
        errs = output_errors(("dx1", "dmod", "dw1", "db1", "dw2", "db2"), got, want, {"dx1": dy})
        check_errors(f"mlp_bwd N={n}", errs, K5_TOL)
        lib = backward_only(torch, lambda *a: library_mlp_half(F, *a)[0],
                            (x1, mod, blk["w1"], blk["b1"], blk["w2"], blk["b2"]), dy)
        bms, by = bound_ms(2 * (4 * n * t * c + n * t * hid + 6 * n * c + 2 * c * hid)
                           + 4 * (3 * n * c + 2 * c * hid + hid + c), 8 * n * t * c * hid)
        row = {"shape": [n, t, c, hid, heads], "max_abs_err": max(e[0] for e in errs.values()),
               "rel_err": {k: e[1] for k, e in errs.items()}, "tol": K5_TOL, "digest": first,
               "ms": time_ms(torch, lambda: mlp_bwd(*margs)),
               "plain_ms": time_ms(torch, lambda: reference_mlp_bwd(*margs)),
               "library_ms": time_ms(torch, lib), "bound_ms": bms, "bound_by": by,
               "seconds": time.time() - t_case}
        k5_rows[("mlp", n)] = row
        emit({"phase": "kernel", "name": "dit_block_train_mlp_bwd", **row})
        dx1 = got[0]
        del got, want, lib

        t_case = time.time()
        aargs = (x, mod, pr, qkv, ao, blk["wqkv"], blk["wproj"], dx1)
        got = attn_bwd(*aargs, num_heads=heads)
        want = reference_attn_bwd(*aargs, num_heads=heads)
        torch.cuda.synchronize()
        errs = output_errors(("dx", "dmod", "dwqkv", "dbqkv", "dwproj", "dbproj"), got, want,
                             {"dx": dx1})
        check_errors(f"attn_bwd N={n}", errs, K5_TOL)
        lib = backward_only(torch, lambda *a: library_attn_half(F, *a, num_heads=heads)[0],
                            (x, mod, blk["wqkv"], blk["bqkv"], blk["wproj"], blk["bproj"]), dx1)
        bms, by = bound_ms(2 * (8 * n * t * c + 6 * n * c + 4 * c * c)
                           + 4 * (3 * n * c + 4 * c * c + 4 * c),
                           # five T x T products a head (logits, dv, dp, dq,
                           # dk); ao is a stream, so the CostEstimate's sixth
                           # (PV again) is not work the function needs
                           16 * n * t * c * c + 10 * n * t * t * c)
        row = {"shape": [n, t, c, hid, heads], "max_abs_err": max(e[0] for e in errs.values()),
               "rel_err": {k: e[1] for k, e in errs.items()}, "tol": K5_TOL,
               "ms": time_ms(torch, lambda: attn_bwd(*aargs, num_heads=heads)),
               "plain_ms": time_ms(torch, lambda: reference_attn_bwd(*aargs, num_heads=heads)),
               "library_ms": time_ms(torch, lib), "bound_ms": bms, "bound_by": by,
               "seconds": time.time() - t_case}
        k5_rows[("attn", n)] = row
        emit({"phase": "kernel", "name": "dit_block_train_attn_bwd", **row})
        del got, want, lib, blk, x, mod, out, x1, h2, pr, qkv, ao, u, dy, dx1

    # the redesigned GEMM (gemm_sm90.cuh): each NT GEMM of K2 at the sampling
    # batch and of K5's forward at the train batch, and each NN / TN GEMM of
    # K5's MLP backward at the train batch, alone, against its bound and
    # torch.matmul of the same product; ptxas's registers and spills of its
    # 8 NT and 6 NN / TN instances
    from lfm_tpu_torch.tools.bench_block import gemm_rows, mlp_gemm_rows

    gemms = {"fused_dit_block": gemm_rows(batch, False, reps=10),
             "dit_block_train_fwd": gemm_rows(train_batch, True, reps=10),
             "dit_block_train_mlp_bwd": mlp_gemm_rows(train_batch, reps=10)}
    gemm_ptxas = {re.sub(r"^_ZN3lfm4sm9016gemm_sm90_kernelI(.*)EEv.*$", r"gemm_sm90_kernel<\1>",
                         k): u
                  for stem in ("gemm_sm90", "gemm_sm90_bwd")
                  for k, u in _build.ptxas_usage(stem).items() if "gemm_sm90_kernel" in k}
    emit({"phase": "gemm_redesign", "source": csrc + "gemm_sm90.cuh", "gemms": gemms,
          "ptxas": gemm_ptxas})
    spilled = {k: u for k, u in gemm_ptxas.items()
               if u.get("spill_stores") or u.get("spill_loads")}
    # NT: 4 epilogue kinds x 2 tile widths; NN dgelu, NN and TN store x 2
    if len(gemm_ptxas) != 14 or spilled:
        raise AssertionError(f"wgmma GEMM: {len(gemm_ptxas)} kernel instances, spills {spilled}")

    # make_fused_block_train against autograd through reference_block, each
    # backward mode a path of its own
    t_case = time.time()
    blk = block_inputs(8)
    dy = rn(8, t, c)
    leaves = [a.detach().requires_grad_(True) for a in blk.values()]
    want = torch.autograd.grad(reference_block(*leaves, num_heads=heads), leaves, dy)
    block_counts, block_errs = {}, {}
    expected = {"block_hybrid": {"dit_block_train_fwd": 1, "attention_small_bwd": 1},
                "block_pallas_bwd": {"dit_block_train_fwd": 1, "dit_block_train_mlp_bwd": 1,
                                     "dit_block_train_attn_bwd": 1}}
    for path, kw in (("block_hybrid", {}), ("block_pallas_bwd", {"pallas_bwd": True})):
        fn = make_fused_block_train(heads, 4, 2, **kw)
        leaves = [a.detach().requires_grad_(True) for a in blk.values()]
        reset_counts()
        got = torch.autograd.grad(fn(*leaves), leaves, dy)
        torch.cuda.synchronize()
        block_counts[path] = counts()
        block_errs[path] = output_errors(list(blk), got, want)
        check_errors(f"make_fused_block_train ({path})", block_errs[path], BLOCK_GRAD_TOL)
        if {k: v for k, v in block_counts[path].items() if v} != expected[path]:
            raise AssertionError(f"{path}: launches {block_counts[path]}, expected "
                                 f"{expected[path]}")
    emit({"phase": "block_train", "shape": [8, t, c, hid, heads], "tol": BLOCK_GRAD_TOL,
          "rel_err": {p: {k: e[1] for k, e in errs.items()} for p, errs in block_errs.items()},
          "launches": block_counts, "seconds": time.time() - t_case})
    del blk, dy, leaves, want, got

    # P1: row quantization and the int8 GEMM at the int8 path's shapes, then
    # the probe's two chains at its own call
    t_case = time.time()
    x = rn(P1_ROWS, 4 * c, dtype=f32)
    q, sq = quant_rows(x)
    wq, wsq = reference_quant_rows(x)
    torch.cuda.synchronize()
    mismatches = int((q != wq).sum()) + int((sq != wsq).sum())
    if mismatches:
        raise AssertionError(f"quant_rows (51200, 4096): {mismatches} values differ from plain")
    bms, by = bound_ms(x.numel() * 5 + 4 * P1_ROWS, 3 * x.numel(), F32_FLOPS)
    p1_rows = {"quant_rows": {
        "shape": list(x.shape), "max_abs_err": 0.0, "mismatches": mismatches,
        "ms": time_ms(torch, lambda: quant_rows(x)),
        "plain_ms": time_ms(torch, lambda: reference_quant_rows(x)), "library_ms": None,
        "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}}
    emit({"phase": "kernel", "name": "quant_rows", **p1_rows["quant_rows"]})
    del x, q, sq, wq, wsq
    int8_cases = (("qkv", c, 3 * c, "store", bf, f32), ("proj", c, c, "store", f32, bf),
                  ("fc1", c, hid, "gelu", f32, f32), ("fc2", hid, c, "store", f32, f32))
    for layer, k, n, epi, odt, xdt in int8_cases:
        t_case = time.time()
        x = rn(P1_ROWS, k, dtype=xdt)
        qw, sw = quantize_weight(rn(n, k, scale=k ** -0.5, dtype=f32))
        b = rn(n, scale=0.02)
        out = int8_dense(x, qw, sw, b, epi, odt)
        ref = reference_int8_dense(x, qw, sw, b, epi, odt)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        tol = INT8_TOL if odt == f32 else 2.0 ** -8
        if not rel <= tol:
            raise AssertionError(f"int8_dense {layer} (51200, {k}) x ({n}, {k}): max abs err "
                                 f"{err} is {rel} of max |plain| > {tol}")
        nbytes = x.numel() * x.element_size() + n * k + 6 * n + P1_ROWS * n * out.element_size()
        bms, by = bound_ms(nbytes, 2 * P1_ROWS * n * k, INT8_OPS)
        row = {"layer": layer, "shape": [P1_ROWS, k, n], "epilogue": epi, "out": str(odt),
               "max_abs_err": err, "rel_err": rel, "tol": tol,
               "ms": time_ms(torch, lambda: int8_dense(x, qw, sw, b, epi, odt)),
               "plain_ms": time_ms(torch, lambda: reference_int8_dense(x, qw, sw, b, epi, odt),
                                   reps=5),
               "library_ms": time_ms(torch, lambda: library_int8_dense(
                   torch, F, x, qw, sw, b, epi == "gelu", odt)),
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        p1_rows[layer] = row
        emit({"phase": "kernel", "name": "int8_dense", **row})
        del x, qw, sw, b, out, ref
    inp = microbench_int8.probe_inputs(dev, SEED)
    dh = microbench_int8.D * microbench_int8.H
    p1_ops = microbench_int8.CHAIN * 2 * (2 * inp["x"].shape[0] * dh)
    # x read and the output written in bf16, the two weights (int8 with their
    # f32 scales, or bf16) read once
    p1_io = 2 * 2 * inp["x"].numel()
    x = inp["x"]
    steps = {"int8_mlp": (int8_mlp(x, inp["w1"], inp["s1"], None, inp["w2"], inp["s2"], None),
                          reference_int8_mlp(x, inp["w1"], inp["s1"], None, inp["w2"],
                                             inp["s2"], None)),
             "bf16_mlp": (bf16_mlp(x, inp["w1b"], inp["w2b"]),
                          reference_bf16_mlp(x, inp["w1b"], inp["w2b"]))}
    for name, run, plain, lib, peak, wbytes, step_tol, chain_tol in (
            ("int8_mlp", microbench_int8.run_int8, reference_int8_mlp,
             lambda *a: library_int8_mlp(torch, F, *a), INT8_OPS,
             2 * dh + 4 * (microbench_int8.D + microbench_int8.H), P1_STEP_TOL, P1_CHAIN_TOL),
            ("bf16_mlp", microbench_int8.run_bf16, reference_bf16_mlp,
             lambda *a: library_bf16_mlp(F, *a), BF16_FLOPS, 4 * dh, BF16_MLP_TOL,
             BF16_MLP_TOL)):
        t_case = time.time()
        out, ref = run(inp), run(inp, plain)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        step_err, step_rel = rel_err(*steps[name])
        if not step_rel <= step_tol:
            raise AssertionError(f"{name}, one step: max abs err {step_err} is {step_rel} of "
                                 f"max |plain| > {step_tol}")
        if not (rel <= chain_tol and float(ref.float().abs().max()) > 0):
            raise AssertionError(f"{name} chain of {microbench_int8.CHAIN}: max abs err {err} "
                                 f"is {rel} of max |plain| > {chain_tol}")
        bms, by = bound_ms(p1_io + wbytes, p1_ops, peak)
        row = {"shape": [inp["x"].shape[0], microbench_int8.D, microbench_int8.H],
               "chain": microbench_int8.CHAIN, "max_abs_err": err, "rel_err": rel,
               "tol": chain_tol, "step_rel_err": step_rel, "step_tol": step_tol,
               "max_plain": float(ref.float().abs().max()),
               "ms": time_ms(torch, lambda: run(inp), reps=5, warmup=1),
               "plain_ms": time_ms(torch, lambda: run(inp, plain), reps=2, warmup=1),
               "library_ms": time_ms(torch, lambda: run(inp, lib), reps=5, warmup=1),
               "bound_ms": bms, "bound_by": by, "seconds": time.time() - t_case}
        p1_rows[name] = row
        emit({"phase": "kernel", "name": name, **row})
        del out, ref
    del inp, x, steps

    # the redesigned int8 GEMM (int8_gemm_sm90.cuh): each of the int8 path's
    # four products and the probe step's two alone, against its bound and
    # torch._int_mm of the same int8 operands; its output against the plain
    # version's and int8_dense's, bit for bit; ptxas's registers and spills
    # of its 8 instances
    from lfm_tpu_torch.tools.bench_int8 import gemm_rows as int8_gemm_rows

    int8_gemms = int8_gemm_rows(reps=10, repeats=1)
    int8_ptxas = {re.sub(r"^_ZN3lfm4sm9021int8_gemm_sm90_kernelI(.*)EEv.*$",
                         r"int8_gemm_sm90_kernel<\1>", k): u
                  for k, u in _build.ptxas_usage("int8_gemm").items()
                  if "int8_gemm_sm90_kernel" in k}
    emit({"phase": "int8_redesign", "source": csrc + "int8_gemm_sm90.cuh", "gemms": int8_gemms,
          "ptxas": int8_ptxas})
    spilled = {k: u for k, u in int8_ptxas.items()
               if u.get("spill_stores") or u.get("spill_loads")}
    # 2 tile widths x GELU or not x f32 or bf16 out
    if len(int8_ptxas) != 8 or spilled:
        raise AssertionError(f"int8 GEMM: {len(int8_ptxas)} kernel instances, spills {spilled}")
    unequal = [r["product"] for r in int8_gemms
               if not (r["equals_plain"] and r["dense_equals_gemm"])]
    if unequal:
        raise AssertionError(f"int8 GEMM: outputs not bit-identical for {unequal}")
    emit({"phase": "kernels_vs_plain", "seconds": time.time() - t0})

    # 3. gradients of a small full-width DiT through K1/K3, and through the
    # fused train path, against plain autograd
    t0 = time.time()
    grads = {}
    for variant in ("kernels", "plain", "fused", "kernels_f32", "plain_f32"):
        small = DiT(img_resolution=32, patch_size=2, hidden_size=1024, depth=2, num_heads=16,
                    dtype=f32 if variant.endswith("f32") else bf,
                    use_flash=variant.startswith("kernels")).to(dev)
        seeded_init_(small, SEED)
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 2)
        z0, z1 = (torch.randn(8, 32, 32, 4, generator=g, device=dev) for _ in range(2))
        tt = torch.rand(8, generator=g, device=dev)
        z_t, u = interpolate(z0, z1, tt)
        if variant == "fused":
            v = dit_fused_apply(small, dict(small.named_parameters()), tt, z_t, train_vjp=True)
        else:
            v = small(tt, z_t, train=True)
        torch.mean(torch.square(v - u)).backward()
        grads[variant] = {name: p.grad.float() for name, p in small.named_parameters()}
        del small, v
    worst = {variant: max((rel_err(grads[variant][name], want)[1], name)
                          for name, want in grads[plain].items())
             for variant, plain in (("kernels", "plain"), ("fused", "plain"),
                                    ("kernels_f32", "plain_f32"))}
    emit({"phase": "grad", "tensors": len(grads["plain"]), "max_rel_err": worst["kernels"][0],
          "tensor": worst["kernels"][1], "tol": GRAD_TOL,
          "fused_max_rel_err": worst["fused"][0], "fused_tensor": worst["fused"][1],
          "f32_max_rel_err": worst["kernels_f32"][0], "f32_tensor": worst["kernels_f32"][1],
          "f32_tol": F32_GRAD_TOL, "seconds": time.time() - t0})
    for variant, tol in (("kernels", GRAD_TOL), ("fused", GRAD_TOL),
                         ("kernels_f32", F32_GRAD_TOL)):
        if not worst[variant][0] <= tol:
            raise AssertionError(f"DiT gradient of {worst[variant][1]} ({variant}): "
                                 f"{worst[variant][0]} > {tol}")
    del grads

    # 4. main path, fused blocks: celeb256_dit, bf16 DiT-L/2, dopri5, VAE decode
    vae = create_vae(dtype=bf, device=dev)
    seeded_init_(vae, SEED + 1)
    depth = model.depth
    noise, y = noise_and_labels(config, SampleRNG(config.sample.seed), range(batch),
                                device=dev)
    sampler = make_sampler(config, model, None, vae, None, device=dev)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    res = sampler(noise, y)
    torch.cuda.synchronize()
    secs = time.time() - t0
    fused_counts = counts()
    k2_launches = FUSED_DIT_BLOCK.count
    img = res.images
    emit({"phase": "main_fused", "seconds": secs, "method": config.sample.method,
          "atol": config.sample.atol, "rtol": config.sample.rtol, "nfe": res.nfe,
          "images": list(img.shape), "launches": fused_counts,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "image_mean": float(img.float().mean()), "image_std": float(img.float().std())})
    if tuple(img.shape) != (batch, 256, 256, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not (bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0 and float(img.max()) <= 1.0):
        raise AssertionError("images are not finite values in [0, 1]")
    if not bool(torch.isfinite(res.latents).all()):
        raise AssertionError("latents are not finite")
    if k2_launches != depth * res.nfe or sum(fused_counts.values()) != k2_launches:
        raise AssertionError(f"fused path: {k2_launches} fused_dit_block launches for NFE "
                             f"{res.nfe} x depth {depth}; launches {fused_counts}")

    # 5. main path, module blocks: attention through attention_small
    mconfig = dataclasses.replace(config, sample=dataclasses.replace(
        config.sample, use_fused_dit=False, method="euler", num_steps=4))
    msampler = make_sampler(mconfig, model, None, vae, None, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    mres = msampler(noise, y)
    torch.cuda.synchronize()
    msecs = time.time() - t0
    module_counts = counts()
    k1_module = ATTENTION_SMALL.count
    mimg = mres.images
    with torch.no_grad():
        tt = torch.full((batch,), 0.5, device=dev)
        v_fused = dit_fused_apply(model, cast_params_bf16(model.state_dict()), tt, noise)
        v_module = model(tt, noise)
    vel_err = float((v_fused - v_module).abs().max()) / float(v_module.abs().max())
    emit({"phase": "main_module", "seconds": msecs, "method": "euler", "nfe": mres.nfe,
          "images": list(mimg.shape), "launches": module_counts, "velocity_rel_err": vel_err,
          "velocity_tol": VEL_TOL})
    if not (bool(torch.isfinite(mimg).all()) and tuple(mimg.shape) == tuple(img.shape)):
        raise AssertionError("module path images are not finite or have the wrong shape")
    if k1_module != depth * mres.nfe or sum(module_counts.values()) != k1_module:
        raise AssertionError(f"module path: {module_counts} launches for NFE {mres.nfe} x "
                             f"depth {depth}")
    if not vel_err <= VEL_TOL:
        raise AssertionError(f"fused vs module velocity: {vel_err} > {VEL_TOL}")
    del sampler, msampler, res, img, v_fused

    # 5b. int8_main: the same model and noise through the w8a8 blocks
    t_int8 = time.time()
    iconfig = dataclasses.replace(config, sample=dataclasses.replace(
        config.sample, use_int8_dit=True, method="euler", num_steps=4))
    torch.cuda.synchronize()
    t0 = time.time()
    isampler = make_sampler(iconfig, model, None, vae, None, device=dev)
    torch.cuda.synchronize()
    quantize_s = time.time() - t0
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    ires = isampler(noise, y)
    torch.cuda.synchronize()
    isecs = time.time() - t0
    int8_counts = counts()
    iimg = ires.images
    with torch.no_grad():
        qparams = quantize_params_int8(model, model.state_dict())
        v_int8 = dit_int8_apply(model, qparams, tt, noise)
        v_int8_plain = dit_int8_apply(model, qparams, tt, noise, plain=True)
    int8_err = float((v_int8 - v_int8_plain).abs().max()) / float(v_int8_plain.abs().max())
    int8_bf16_err = float((v_int8 - v_module).abs().max()) / float(v_module.abs().max())
    per_eval = 4 * depth
    emit({"phase": "int8_main", "seconds": isecs, "samples_per_s": batch / isecs,
          "method": "euler", "nfe": ires.nfe, "quantize_seconds": quantize_s,
          "images": list(iimg.shape), "launches": int8_counts,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "velocity_rel_err_vs_plain": int8_err, "velocity_tol": INT8_VEL_TOL,
          "velocity_rel_err_vs_bf16_module": int8_bf16_err, "vs_bf16_tol": INT8_VS_BF16_TOL,
          "image_mean": float(iimg.float().mean()), "phase_seconds": time.time() - t_int8})
    if tuple(iimg.shape) != (batch, 256, 256, 3) or not (
            bool(torch.isfinite(iimg).all()) and bool(torch.isfinite(ires.latents).all())):
        raise AssertionError(f"int8 images {tuple(iimg.shape)} are not finite or mis-shaped")
    want_counts = {"quant_rows": per_eval * ires.nfe, "int8_dense": per_eval * ires.nfe}
    if {k: v for k, v in int8_counts.items() if v} != want_counts:
        raise AssertionError(f"int8 path: launches {int8_counts}, expected {want_counts}")
    if not int8_err <= INT8_VEL_TOL:
        raise AssertionError(f"int8 velocity vs its plain version: {int8_err} > {INT8_VEL_TOL}")
    if not int8_bf16_err <= INT8_VS_BF16_TOL:
        raise AssertionError(f"int8 vs bf16 module velocity: {int8_bf16_err} > "
                             f"{INT8_VS_BF16_TOL}")
    del isampler, ires, qparams, v_int8, v_int8_plain, v_module, noise
    torch.cuda.empty_cache()

    # 5c. fid: seeded Inception over the bf16 module's and the int8 images
    t_fid = time.time()
    inception_sd = seeded_inception_state_dict(SEED)
    extractor = ActivationExtractor(inception_sd, device=dev)
    act_cpu = ActivationExtractor(inception_sd, device="cpu")(mimg[:2].cpu())
    act_dev = extractor(mimg[:2])
    act_err = float(abs(act_dev - act_cpu).max()) / float(abs(act_cpu).max())
    extractor(mimg[:50])  # warm-up (cuDNN's algorithm choice)
    torch.cuda.synchronize()
    t0 = time.time()
    acts = {name: extractor.over_batches(images.split(50)) for name, images in
            (("bf16", mimg), ("int8", iimg))}
    torch.cuda.synchronize()
    extract_s = time.time() - t0
    t0 = time.time()
    fid = calculate_frechet_distance(*activation_statistics(acts["int8"]),
                                     *activation_statistics(acts["bf16"]))
    sqrtm_s = time.time() - t0
    emit({"phase": "fid", "images": [int(mimg.shape[0]), int(iimg.shape[0])],
          "features": int(acts["int8"].shape[1]), "fid_int8_vs_bf16": fid,
          "weights": "seeded (no pt_inception checkpoint in the repository): a "
                     "protocol-level number, not image quality",
          "activation_rel_err_vs_cpu": act_err, "activation_tol": FID_ACT_TOL,
          "extract_ms_per_image": 1e3 * extract_s / (2 * batch), "sqrtm_seconds": sqrtm_s,
          "phase_seconds": time.time() - t_fid})
    if not math.isfinite(fid):
        raise AssertionError(f"Fréchet distance int8 vs bf16 is not finite: {fid}")
    if not act_err <= FID_ACT_TOL:
        raise AssertionError(f"Inception activations on the card vs the CPU: {act_err} > "
                             f"{FID_ACT_TOL}")
    del extractor, acts, mimg, iimg, inception_sd
    torch.cuda.empty_cache()

    # 5d. p1_probe: P1's probe tool, int8_mlp against bf16_mlp
    reset_counts()
    p1_line = microbench_int8.measure(dev)
    probe_counts = counts()
    calls = microbench_int8.CHAIN * (1 + microbench_int8.REPS)
    emit({"phase": "p1_probe", **p1_line, "launches": probe_counts})
    if {k: v for k, v in probe_counts.items() if v} != {"int8_mlp": calls, "bf16_mlp": calls}:
        raise AssertionError(f"p1_probe: launches {probe_counts}, expected {calls} of each")

    # 6. adm_main: celeb256_adm, bf16 origin-ADM UNet, dopri5, VAE decode
    t_adm = time.time()
    aconfig = get_preset("celeb256_adm")
    am = aconfig.model
    adm = create_network(am, dtype=bf, use_flash=am.use_flash_attention, device=dev)
    seeded_init_(adm, SEED)
    layers = list(plan_layers(adm.plan))
    n_attn = sum(spec.kind == "attn" for spec in layers)
    n_res = sum(spec.kind.startswith("res") for spec in layers)
    # _GNSiLU: every ResBlock's in-norm, and its out-norm without scale-shift
    gn_per_eval = n_res * (1 if am.use_scale_shift_norm else 2)
    anoise, ay = noise_and_labels(aconfig, SampleRNG(aconfig.sample.seed), range(batch),
                                  device=dev)
    asampler = make_sampler(aconfig, adm, None, vae, None, device=dev)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    ares = asampler(anoise, ay)
    torch.cuda.synchronize()
    asecs = time.time() - t0
    adm_counts = counts()
    aimg = ares.images
    emit({"phase": "adm_main", "preset": "celeb256_adm", "seconds": asecs,
          "method": aconfig.sample.method, "atol": aconfig.sample.atol,
          "rtol": aconfig.sample.rtol, "nfe": ares.nfe, "images": list(aimg.shape),
          "params": sum(p.numel() for p in adm.parameters()), "attention_layers": n_attn,
          "resblocks": n_res, "launches": adm_counts,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "image_mean": float(aimg.float().mean()), "image_std": float(aimg.float().std()),
          "phase_seconds": time.time() - t_adm})
    if tuple(aimg.shape) != (batch, 256, 256, 3):
        raise AssertionError(f"adm image shape {tuple(aimg.shape)}")
    if not (bool(torch.isfinite(aimg).all()) and float(aimg.min()) >= 0.0
            and float(aimg.max()) <= 1.0 and bool(torch.isfinite(ares.latents).all())):
        raise AssertionError("adm images are not finite values in [0, 1]")
    k1_adm = adm_counts["attention_small"]
    if k1_adm != n_attn * ares.nfe or sum(adm_counts.values()) != k1_adm:
        raise AssertionError(f"adm path: {adm_counts} launches for NFE {ares.nfe} x "
                             f"{n_attn} attention layers")

    # 7. adm_fused_gn: the same weights, GroupNorm + SiLU through K6, euler
    t_fgn = time.time()
    fconfig = dataclasses.replace(aconfig, sample=dataclasses.replace(
        aconfig.sample, method="euler", num_steps=ADM_FUSED_STEPS))
    adm_fused = create_network(am, dtype=bf, use_flash=am.use_flash_attention,
                               use_fused_gn=True, device=dev)
    adm_fused.load_state_dict(adm.state_dict())
    fsampler = make_sampler(fconfig, adm_fused, None, vae, None, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    fres = fsampler(anoise, ay)
    torch.cuda.synchronize()
    fsecs = time.time() - t0
    fgn_counts = counts()
    with torch.no_grad():
        tt = torch.full((batch,), 0.5, device=dev)
        v_fgn, v_plain = adm_fused(tt, anoise), adm(tt, anoise)
    fgn_err = float((v_fgn - v_plain).abs().max()) / float(v_plain.abs().max())
    emit({"phase": "adm_fused_gn", "seconds": fsecs, "method": "euler", "nfe": fres.nfe,
          "images": list(fres.images.shape), "launches": fgn_counts,
          "groupnorm_silu_per_eval": gn_per_eval, "velocity_rel_err": fgn_err,
          "velocity_tol": VEL_TOL, "phase_seconds": time.time() - t_fgn})
    if not (bool(torch.isfinite(fres.images).all())
            and tuple(fres.images.shape) == tuple(aimg.shape)):
        raise AssertionError("adm_fused_gn images are not finite or have the wrong shape")
    k6_fgn, k1_fgn = fgn_counts["groupnorm_silu"], fgn_counts["attention_small"]
    if (k6_fgn != gn_per_eval * fres.nfe or k1_fgn != n_attn * fres.nfe
            or sum(fgn_counts.values()) != k6_fgn + k1_fgn):
        raise AssertionError(f"adm_fused_gn: {fgn_counts} launches for NFE {fres.nfe}, "
                             f"{gn_per_eval} GroupNorm + SiLU and {n_attn} attention per eval")
    if not fgn_err <= VEL_TOL:
        raise AssertionError(f"fused vs plain GroupNorm + SiLU velocity: {fgn_err} > {VEL_TOL}")
    del adm, adm_fused, asampler, fsampler, ares, fres, aimg, anoise, v_fgn, v_plain
    torch.cuda.empty_cache()

    # 8. long_t: DiT-L/2 at 1024 px (T = 4096), module path through K4
    t_long = time.time()
    lconfig = dataclasses.replace(
        config, model=dataclasses.replace(config.model, image_size=LONG_T_SIZE),
        sample=dataclasses.replace(config.sample, method="euler", num_steps=2, batch_size=2))
    long_model = create_network(lconfig.model, dtype=bf,
                                use_flash=lconfig.model.use_flash_attention, device=dev)
    long_model.load_state_dict(model.state_dict())
    tokens = (long_model.img_resolution // long_model.patch_size) ** 2
    lnoise, ly = noise_and_labels(lconfig, SampleRNG(lconfig.sample.seed),
                                  range(lconfig.sample.batch_size), device=dev)
    lsampler = make_sampler(lconfig, long_model, None, vae, None, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    lres = lsampler(lnoise, ly)
    torch.cuda.synchronize()
    lsecs = time.time() - t0
    long_counts = counts()
    limg = lres.images
    emit({"phase": "long_t", "image_size": LONG_T_SIZE, "tokens": tokens, "seconds": lsecs,
          "method": "euler", "nfe": lres.nfe, "images": list(limg.shape),
          "launches": long_counts, "image_mean": float(limg.float().mean()),
          "phase_seconds": time.time() - t_long})
    if tuple(limg.shape) != (2, LONG_T_SIZE, LONG_T_SIZE, 3) or not bool(
            torch.isfinite(limg).all()):
        raise AssertionError(f"long_t images {tuple(limg.shape)} are not finite or mis-shaped")
    k4_long = long_counts["flash_attention"]
    if k4_long != depth * lres.nfe or sum(long_counts.values()) != k4_long:
        raise AssertionError(f"long_t: {long_counts} launches for NFE {lres.nfe} x depth {depth}")
    del long_model, lsampler, lres, limg, lnoise
    torch.cuda.empty_cache()

    # 8b. long_f32: an f32 DiT-L/2 at 512 px (T = 1024), module path through
    # f32 K1 past T = 256 (attention_long_f32.cuh)
    t_lf = time.time()
    fconfig = dataclasses.replace(
        config, model=dataclasses.replace(config.model, image_size=LONG_F32_SIZE),
        sample=dataclasses.replace(config.sample, method="euler", num_steps=2, batch_size=2))
    f32_models = {}
    for use_flash in (True, False):  # the kernels, and plain attention
        f32_models[use_flash] = create_network(fconfig.model, dtype=f32, use_flash=use_flash,
                                               device=dev)
        f32_models[use_flash].load_state_dict(model.state_dict())
    lf_tokens = (f32_models[True].img_resolution // f32_models[True].patch_size) ** 2
    fnoise, fy = noise_and_labels(fconfig, SampleRNG(fconfig.sample.seed),
                                  range(fconfig.sample.batch_size), device=dev)
    fsampler = make_sampler(fconfig, f32_models[True], None, vae, None, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    fres = fsampler(fnoise, fy)
    torch.cuda.synchronize()
    lf_secs = time.time() - t0
    lf_counts = counts()
    lf_dtypes = dict(ATTENTION_SMALL.by_dtype)
    fimg = fres.images
    with torch.no_grad():
        tt = torch.full((fconfig.sample.batch_size,), 0.5, device=dev)
        v_lf, v_lf_plain = (f32_models[k](tt, fnoise) for k in (True, False))
    lf_err = float((v_lf - v_lf_plain).abs().max()) / float(v_lf_plain.abs().max())
    emit({"phase": "long_f32", "image_size": LONG_F32_SIZE, "tokens": lf_tokens,
          "seconds": lf_secs, "method": "euler", "nfe": fres.nfe, "images": list(fimg.shape),
          "launches": lf_counts, "launches_by_dtype": lf_dtypes,
          "velocity_rel_err_vs_plain_attention": lf_err, "velocity_tol": F32_VEL_TOL,
          "image_mean": float(fimg.float().mean()), "phase_seconds": time.time() - t_lf})
    if tuple(fimg.shape) != (2, LONG_F32_SIZE, LONG_F32_SIZE, 3) or not bool(
            torch.isfinite(fimg).all()) or v_lf.dtype != f32:
        raise AssertionError(f"long_f32 images {tuple(fimg.shape)} are not finite or "
                             f"mis-shaped, or the velocity is {v_lf.dtype}")
    k1_lf = depth * fres.nfe
    if lf_tokens != 1024 or lf_counts["attention_small"] != k1_lf or sum(
            lf_counts.values()) != k1_lf or lf_dtypes != {"float32": k1_lf}:
        raise AssertionError(f"long_f32: T = {lf_tokens}, {lf_counts} launches by dtype "
                             f"{lf_dtypes} for NFE {fres.nfe} x depth {depth}")
    if not lf_err <= F32_VEL_TOL:
        raise AssertionError(f"long_f32 velocity vs plain attention: {lf_err} > {F32_VEL_TOL}")
    del f32_models, fsampler, fres, fimg, fnoise, v_lf, v_lf_plain
    torch.cuda.empty_cache()

    # 9. train: celeb256_dit through train(...), from the seeded weights above
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
        reset_counts()
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
    train_counts = counts()
    k1_train, k3_train = ATTENTION_SMALL.count, ATTENTION_SMALL_BWD.count
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tdepth = len([name for name in state.names if name.endswith("attn.qkv.weight")])
    finite = all(bool(torch.isfinite(p).all()) for p in state.params)
    sec_per_step = (t_end - t_log) / (TRAIN_STEPS - 1)
    emit({"phase": "train", "preset": "celeb256_dit", "model": config.model.model_type,
          "batch": train_batch, "steps": state.step, "seconds_per_step": sec_per_step,
          "images_per_s": train_batch / sec_per_step, "peak_gib": peak,
          "loss_step1": loss1, "loss_step1_again": loss_again, "log": line,
          "run_seconds": [run1_s, run_s], "launches": train_counts,
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
            or k1_train != 2 * tdepth * TRAIN_STEPS
            or sum(train_counts.values()) != k1_train + k3_train):
        raise AssertionError(f"train: {state.step} steps, {k3_train} attention_small_bwd and "
                             f"{k1_train} attention_small launches for depth {tdepth}")
    del state
    torch.cuda.empty_cache()

    # 10. train_fused: the same step through the fused blocks (K5's forward,
    # the hybrid backward through K3), from the same weights, batches and draws
    t_tf = time.time()
    fmodel = create_network(config.model, dtype=bf, use_flash=config.model.use_flash_attention,
                            device=dev)
    fmodel.load_state_dict(reference_state_dict(torch.load(ckpt_path, map_location="cpu",
                                                           weights_only=False)))
    fmodel.train()
    loader = DataLoader(dataset, train_batch, shuffle=True, drop_last=True, seed=tc.seed)
    loader.set_epoch(0)
    fstate = create_train_state(fmodel)
    fstep = make_train_step(
        fmodel, make_optimizer(tc, tc.steps_per_epoch or max(len(loader), 1)),
        model_apply=dit_fused_model_apply(fmodel), ema_decay=tc.ema_decay, use_ema=tc.use_ema,
        encode_fn=vae.encode_sample, scale_factor=config.scale_factor, seed=tc.seed + 1)
    batches = iter(loader)

    def fused_step():
        return fstep(fstate, {"x": torch.from_numpy(next(batches)["x"]).to(dev)})

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    floss1 = float(fused_step()[0])
    i = fstate.names.index(probe)
    p1, ema1 = fstate.params[i].detach(), fstate.ema[i].detach()
    fema_err = float((ema1 - (decay * p0 + (1 - decay) * p1)).abs().max())
    fmoved = float((p1 - p0).abs().max())
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(TRAIN_STEPS):
        floss = fused_step()[0]
    torch.cuda.synchronize()
    fsec_per_step = (time.time() - t0) / TRAIN_STEPS
    tf_counts = counts()
    fpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    fsteps = fstate.step
    ffinite = all(bool(torch.isfinite(p).all()) for p in fstate.params)
    floss_err = abs(floss1 - loss1) / abs(loss1)
    emit({"phase": "train_fused", "preset": "celeb256_dit", "model": config.model.model_type,
          "batch": train_batch, "steps": fsteps, "seconds_per_step": fsec_per_step,
          "images_per_s": train_batch / fsec_per_step, "peak_gib": fpeak,
          "loss_step1": floss1, "module_loss_step1": loss1, "loss_rel_err": floss_err,
          "loss_tol": FUSED_LOSS_TOL, "loss_last": float(floss), "launches": tf_counts,
          "ema_max_abs_err": fema_err, "param_max_change_step1": fmoved,
          "params_finite": ffinite, "seconds": time.time() - t_tf})
    if not (math.isfinite(floss1) and ffinite):
        raise AssertionError(f"train_fused: step 1's loss {floss1} or the parameters are not "
                             "finite")
    if not floss_err <= FUSED_LOSS_TOL:
        raise AssertionError(f"train_fused: step 1's loss {floss1} is {floss_err} off the module "
                             f"path's {loss1} > {FUSED_LOSS_TOL}")
    if not (fmoved > 0 and fema_err <= 1e-6 * float(p0.abs().max())):
        raise AssertionError(f"train_fused: parameters moved {fmoved}; EMA off by {fema_err}")
    want_counts = {"dit_block_train_fwd": tdepth * fsteps, "attention_small_bwd": tdepth * fsteps}
    if fsteps != 1 + TRAIN_STEPS or {k: v for k, v in tf_counts.items() if v} != want_counts:
        raise AssertionError(f"train_fused: {fsteps} steps, launches {tf_counts}, expected "
                             f"{want_counts}")
    del fstate, fstep, fmodel, p1, ema1
    torch.cuda.empty_cache()

    # 10b. train_f32: the same train(...) in f32, every attention through f32
    # K1 and K3; step 1's loss against the same model with plain attention
    t_f32 = time.time()
    f32_config = dataclasses.replace(tconfig, train=dataclasses.replace(tc, precision="f32"))
    reset_counts()
    f32_run = bench_train.timed_train(f32_config, dataset, vae, dev, TRAIN_F32_STEPS)
    f32_counts = counts()
    f32_dtypes = {name: dict(c.by_dtype) for name, c in counters.items() if c.by_dtype}
    f32_state = f32_run.pop("state")
    f32_finite = all(bool(torch.isfinite(p).all()) for p in f32_state.params)
    f32_param_dtypes = sorted({str(p.dtype) for p in f32_state.params})
    f32_steps = f32_state.step
    del f32_state
    torch.cuda.empty_cache()
    pmodel = create_network(config.model, dtype=f32, use_flash=False,
                            remat=tc.use_grad_checkpointing, remat_policy=tc.remat_policy,
                            device=dev)
    p_weights = reference_state_dict(torch.load(ckpt_path, map_location="cpu",
                                                weights_only=False))
    pmodel.load_state_dict(p_weights)
    pmodel.train()
    ploader = DataLoader(dataset, train_batch, shuffle=True, drop_last=True, seed=tc.seed)
    ploader.set_epoch(0)
    pbatch = {"x": torch.from_numpy(next(iter(ploader))["x"]).to(dev)}
    pstep = make_train_step(
        pmodel, make_optimizer(tc, tc.steps_per_epoch or max(len(ploader), 1)),
        ema_decay=tc.ema_decay, use_ema=tc.use_ema, encode_fn=vae.encode_sample,
        scale_factor=config.scale_factor, label_dropout=config.model.label_dropout > 0,
        seed=tc.seed + 1)
    reset_counts()
    ploss1 = float(pstep(create_train_state(pmodel), pbatch)[0])
    plain_counts = counts()

    # the same plain step from the same weights with attention's products in
    # TF32 (the rest in f32): how far an attention error of TF32's size moves
    # step 1's loss, against which F32_LOSS_TOL is set
    def tf32_attention(*qkv):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return reference_attention(*qkv)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    pmodel.load_state_dict(p_weights)
    nn_layers.reference_attention = tf32_attention
    try:
        tf32_loss1 = float(pstep(create_train_state(pmodel), pbatch)[0])
    finally:
        nn_layers.reference_attention = reference_attention
    del pmodel, pstep, p_weights, pbatch
    torch.cuda.empty_cache()
    f32_loss_err = abs(f32_run["loss_step1"] - ploss1) / abs(ploss1)
    tf32_loss_err = abs(tf32_loss1 - ploss1) / abs(ploss1)
    emit({"phase": "train_f32", "preset": "celeb256_dit", "model": config.model.model_type,
          "batch": train_batch, "precision": "f32", "steps": f32_steps,
          **{k: f32_run[k] for k in ("seconds_per_step", "images_per_s", "peak_gib",
                                     "loss_step1")},
          "plain_attention_loss_step1": ploss1, "loss_rel_err": f32_loss_err,
          "loss_tol": F32_LOSS_TOL, "tf32_attention_loss_step1": tf32_loss1,
          "tf32_attention_loss_rel_err": tf32_loss_err, "launches": f32_counts, "launches_by_dtype": f32_dtypes,
          "param_dtypes": f32_param_dtypes, "params_finite": f32_finite,
          "card": torch.cuda.get_device_name(0), "seconds": time.time() - t_f32})
    if not (math.isfinite(f32_run["loss_step1"]) and f32_finite
            and f32_param_dtypes == [str(f32)]):
        raise AssertionError(f"train_f32: step 1's loss {f32_run['loss_step1']}, parameters "
                             f"finite {f32_finite}, dtypes {f32_param_dtypes}")
    if not f32_loss_err <= F32_LOSS_TOL:
        raise AssertionError(f"train_f32: step 1's loss {f32_run['loss_step1']} is "
                             f"{f32_loss_err} off plain attention's {ploss1} > {F32_LOSS_TOL}")
    if not tf32_loss_err > F32_LOSS_TOL:
        raise AssertionError(f"train_f32: attention in TF32 moves step 1's loss by only "
                             f"{tf32_loss_err} <= {F32_LOSS_TOL}: the loss check cannot tell it "
                             "from f32")
    want_counts = {"attention_small": 2 * tdepth * f32_steps,
                   "attention_small_bwd": tdepth * f32_steps}
    want_dtypes = {k: {"float32": v} for k, v in want_counts.items()}
    if (f32_steps != 1 + TRAIN_F32_STEPS
            or {k: v for k, v in f32_counts.items() if v} != want_counts
            or f32_dtypes != want_dtypes or any(plain_counts.values())):
        raise AssertionError(f"train_f32: {f32_steps} steps, launches {f32_counts} by dtype "
                             f"{f32_dtypes}, expected {want_dtypes}; plain step {plain_counts}")

    # 11. the kernels line, the card, the last line
    by_path = {"main_fused": fused_counts, "main_module": module_counts,
               "int8_main": int8_counts, "p1_probe": probe_counts, "adm_main": adm_counts,
               "adm_fused_gn": fgn_counts, "long_t": long_counts, "long_f32": lf_counts,
               "train": train_counts,
               "train_fused": tf_counts, "train_f32": f32_counts, **block_counts}
    kdir, p1 = "lfm_tpu/kernels/", "tools/microbench_int8_pallas.py"
    # name, source (the C entry's or kernel's file first, then the files
    # of the kernels it launches), TPU kernel, the path whose count is
    # "launches", the row; the f32 K1 and K3 entries count under
    # attention_small(_bwd)
    kernels = (
        ("attention_small", "attention_sm90.cuh", kdir + "flash_attention.py:163", "train",
         k1_rows[(train_batch, 256, 16, 64, bf)]),
        ("attention_small_f32", "attention_wide.cu", kdir + "flash_attention.py:163", "adm_main",
         k1_rows[(batch, 16, 4, 128, f32)]),
        ("attention_small_f32_dit", "attention_row_f32.cuh", kdir + "flash_attention.py:163",
         "train_f32", k1_rows[(train_batch, 256, 16, 64, f32)]),
        ("attention_small_f32_long", ("attention_long_f32.cuh", "attention_long_f32.cu",
                                      "flash_attention_f32.cu"),
         kdir + "flash_attention.py:163", "long_f32", k1_rows[(2, 1024, 16, 64, f32)]),
        ("attention_small_bwd_f32", "attention_row_f32.cuh", kdir + "flash_attention.py:233",
         "train_f32", k3_rows[(train_batch, 256, 64, f32)]),
        ("fused_dit_block", "dit_block.cu", kdir + "dit_block.py:135", "main_fused",
         k2_rows[batch]),
        ("attention_small_bwd", "attention_bwd_sm90.cuh", kdir + "flash_attention.py:233", "train",
         k3_rows[(train_batch, 256, 64, bf)]),
        ("flash_attention", "attention_sm90.cuh", kdir + "flash_attention.py:74", "long_t",
         k4_rows[(2, 4096, 16, 64, bf)]),
        ("groupnorm_silu", "groupnorm_silu.cu", kdir + "groupnorm_silu.py:68", "adm_fused_gn",
         k6_rows[(batch, 32, 32, 256, bf, 0.0)]),
        ("dit_block_train_fwd", "dit_block_train.cu", kdir + "dit_block_train.py:357",
         "train_fused", k5_rows[("fwd", "full", train_batch)]),
        ("dit_block_train_mlp_bwd", ("dit_block_train.cu", "gemm_sm90.cuh", "gemm_sm90_bwd.cu"),
         kdir + "dit_block_train.py:398", "block_pallas_bwd", k5_rows[("mlp", train_batch)]),
        ("dit_block_train_attn_bwd", "dit_block_train.cu", kdir + "dit_block_train.py:429",
         "block_pallas_bwd", k5_rows[("attn", train_batch)]),
        ("quant_rows", "int8_gemm.cu", p1 + ":92", "int8_main", p1_rows["quant_rows"]),
        ("int8_dense", "int8_gemm_sm90.cuh", p1 + ":92", "int8_main", p1_rows["fc2"]),
        ("int8_mlp", "int8_gemm_sm90.cuh", p1 + ":92", "p1_probe", p1_rows["int8_mlp"]),
        ("bf16_mlp", "int8_gemm.cu", p1 + ":103", "p1_probe", p1_rows["bf16_mlp"]),
    )
    def counter(name):
        return re.sub(r"_f32(_dit|_long)?$", "", name)

    def sources(src):
        return [csrc + f for f in ((src,) if isinstance(src, str) else src)]

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": sources(src)[0], "sources": sources(src),
         "replaces": tpu, "launches": by_path[path][counter(name)],
         "launches_by_path": {p: c[counter(name)] for p, c in by_path.items()},
         **{key: row[key] for key in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}}
        for name, src, tpu, path, row in kernels
    ], "seconds_total": time.time() - t_all})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
