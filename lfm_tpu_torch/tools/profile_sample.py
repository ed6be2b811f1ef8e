"""Where the time of a sampling run goes on the card.

    python -m lfm_tpu_torch.tools.profile_sample [--preset celeb256_adm] [--fused_gn]
        [--int8_dit] [--batch_size N] [--out DIR]

Builds the preset's network in bf16 as ``cli.main sample`` does (attention
through the kernels; a DiT through the fused block kernel), with seeded
non-zero weights, and a seeded full-width VAE. Then, at the preset's
sampling batch (or ``--batch_size``; CFG doubles it where the preset
guides), it runs ``make_sampler``'s ODE (euler, ``STEPS``
evaluations, no VAE) and the VAE decode of its latents, each once untimed
to warm up and once under ``torch.profiler`` with device activity only,
after an untraced timed run of the same call. From each trace:

- wall: the first kernel's start to the last kernel's end; busy: the
  union of the kernel intervals; idle: the rest (launches and host syncs
  the device waits for);
- device time by kernel class: the port's kernels (K1, K2, K4, K6 and
  P1's int8 GEMM and row quantization) by name, cuDNN convolutions,
  matmuls, ATen's GroupNorm statistics, concatenation, copies and casts,
  and the other elementwise kernels.

``--fused_gn`` sends an ADM's ResBlock GroupNorm + SiLU through K6;
``--int8_dit`` samples a DiT through the w8a8 blocks (nn/dit_int8.py). Prints
one JSON line and writes it, with both Chrome traces, to ``--out``
(default ``saved_info/profile_sample/``). The profiler's own cost per
launch is in the traced wall time; the untraced seconds are beside it.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from collections import defaultdict

import torch

STEPS = 8  # euler steps of the traced ODE: one evaluation each
CONV, K2 = "convolution (cuDNN)", "K2 fused_dit_block"
# kernel name -> class, first match wins (lower-case substrings of the
# demangled name)
CLASSES = (
    # int8_gemm_sm90.cuh's s8 wgmma GEMM, and the WMMA kernel it replaced
    # (a trace of an older checkout)
    ("P1 int8_gemm", ("lfm::sm90::int8_gemm_sm90_kernel", "lfm::int8_gemm_kernel")),
    ("P1 quant_rows", ("lfm::quant_rows_kernel",)),
    # K2's GEMMs run gemm_sm90.cuh's kernel (the P1 probe's bf16_mlp too,
    # which no sampling path runs; gemm_nt_kernel in an older checkout's
    # trace)
    (K2, ("lfm::sm90::gemm_sm90_kernel", "lfm::sm90::gemm_nt_kernel",
          "lfm::ln_modulate_kernel")),
    # bf16 K1 and K4 are attention_sm90.cuh's two modes (K1 takes the
    # key-block one only past T = 256, which no shipped preset reaches);
    # f32 K1 runs attn_row_kernel (D 56-80 at T <= 256),
    # attn_short_f32_kernel (D 128/256 at T <= 64) and past those
    # long32::flash_f32_kernel (its 32-row instances are K1's alone; at D <=
    # 128 and T <= 512 K1 takes K4's instances, classed K4 below;
    # attn_small_kernel in an older checkout's trace); f32 K4
    # long32::flash_f32_kernel (flash_attn_kernel in an older checkout's trace)
    ("K1 attention_small", ("attn_small_kernel", "attn_short_f32_kernel",
                            "row32::attn_row_kernel", "sm90::attn_whole_kernel",
                            "flash_f32_kernel<64, 32, 1024>", "flash_f32_kernel<80, 32, 1024>",
                            "flash_f32_kernel<128, 32, 1024>",
                            "flash_f32_kernel<256, 32, 1024>")),
    ("K4 flash_attention", ("long32::flash_f32_kernel", "flash_attn_kernel",
                            "sm90::attn_blocked_kernel")),
    ("K6 groupnorm_silu", ("gn_silu_kernel",)),
    (CONV, ("cudnn", "implicit_gemm", "xmma", "conv", "fprop")),
    ("matmul", ("nvjet", "gemm", "cutlass", "cublas")),
    ("GroupNorm statistics (ATen)", ("rowwisemoments", "computefusedparams", "groupnorm")),
    ("concatenation", ("catarray",)),
    ("copy / cast", ("copy_kernel",)),
    ("reduction", ("reduce_kernel",)),
)


def classify(name: str) -> str:
    low = name.lower()
    if "lfm::sm90::attn_" in low and "true>" in low:  # NORM_P: K2's attention
        return K2
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "elementwise / other"


def summarize(kernels, per: int = 1) -> dict:
    """Wall, busy and idle of one trace's kernels (sorted by start), and
    device time by class; ms, divided by ``per``."""
    start = kernels[0].time_range.start
    end, busy = start, 0.0
    by_class = defaultdict(float)
    for k in kernels:
        a, b = k.time_range.start, k.time_range.end
        busy += max(b - max(a, end), 0.0)
        end = max(end, b)
        by_class[classify(k.name)] += b - a
    wall = end - start
    ms = lambda us: us / per / 1e3  # noqa: E731
    return {"wall_ms": ms(wall), "busy_ms": ms(busy), "idle_share": 1.0 - busy / wall,
            "kernels": len(kernels) / per,
            "ms_by_class": {c: ms(v) for c, v in sorted(by_class.items(), key=lambda kv: -kv[1])}}


def _trace(fn):
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up (cuDNN's choice of algorithm, the library's build)
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    return out, seconds, kernels, prof


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="profile_sample")
    p.add_argument("--preset", type=str, default="celeb256_adm")
    p.add_argument("--fused_gn", action="store_true")
    p.add_argument("--int8_dit", action="store_true")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--out", type=str, default="saved_info/profile_sample")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_sample: CUDA is not available", file=sys.stderr)
        return 1
    from lfm_tpu_torch.core.config import get_preset
    from lfm_tpu_torch.core.rng import SampleRNG
    from lfm_tpu_torch.nn.factory import create_network
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.sample.sample import make_sampler, noise_and_labels
    from lfm_tpu_torch.vae.autoencoder_kl import create_vae

    dev = torch.device("cuda")
    preset = get_preset(args.preset)
    sample = dataclasses.replace(preset.sample, method="euler", num_steps=STEPS,
                                 use_int8_dit=args.int8_dit,
                                 batch_size=args.batch_size or preset.sample.batch_size)
    config = dataclasses.replace(preset, sample=sample)
    model = create_network(config.model, dtype=torch.bfloat16,
                           use_flash=config.model.use_flash_attention,
                           use_fused_gn=args.fused_gn, device=dev)
    seeded_init_(model, 0)
    vae = create_vae(dtype=torch.bfloat16, device=dev)
    seeded_init_(vae, 1)
    noise, y = noise_and_labels(config, SampleRNG(sample.seed), range(sample.batch_size),
                                device=dev)
    ode = make_sampler(config, model, device=dev)
    res, ode_s, ode_kernels, ode_prof = _trace(lambda: ode(noise, y))
    with torch.no_grad():
        _, dec_s, dec_kernels, dec_prof = _trace(
            lambda: vae.decode(res.latents / config.scale_factor))
    nfe = int(res.nfe)
    line = {
        "phase": "profile_sample", "preset": args.preset, "model": type(model).__name__,
        "batch": sample.batch_size, "cfg_scale": sample.cfg_scale, "method": "euler", "nfe": nfe,
        "fused_gn": args.fused_gn,
        "use_fused_dit": sample.use_fused_dit, "use_int8_dit": sample.use_int8_dit,
        "ode_seconds_untraced": ode_s, "decode_seconds_untraced": dec_s,
        "ode_per_nfe": summarize(ode_kernels, per=nfe), "decode": summarize(dec_kernels),
        "device": torch.cuda.get_device_name(0),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    print(json.dumps(line), flush=True)
    os.makedirs(args.out, exist_ok=True)
    tag = (f"{args.preset}_b{sample.batch_size}{'_fused_gn' if args.fused_gn else ''}"
           f"{'_int8' if args.int8_dit else ''}")
    with open(os.path.join(args.out, f"profile_sample_{tag}.json"), "w") as f:
        f.write(json.dumps(line, indent=1))
    ode_prof.export_chrome_trace(os.path.join(args.out, f"trace_ode_{tag}.json"))
    dec_prof.export_chrome_trace(os.path.join(args.out, f"trace_decode_{tag}.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
