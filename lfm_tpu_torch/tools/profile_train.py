"""Where the time of the celeb256_dit train loop goes on the card.

    python -m lfm_tpu_torch.tools.profile_train [--out DIR] [--fused | --precision f32]

Runs the training loop itself, ``train(...)`` of ``train/loop.py``, on the
celeb256_dit preset (DiT-L/2, batch 32, bf16 on f32 masters, grad
checkpointing, EMA; ``--precision f32``: f32 compute, every attention
through f32 K1 and K3) from its fresh initialisation, with a seeded
full-width VAE encoder over synthetic 256^2 images, for
``WARMUP + STEPS + 1`` steps, all under ``torch.profiler`` with device
activity only (no host events, which would slow the host). With
``--fused`` the same steps go through ``make_train_step(model_apply=
dit_fused_model_apply(model))`` instead (the fused blocks: K5's forward and
the hybrid backward through K3), over the same batches in the loop's order.
Every number comes from the kernels of that one trace:

- a step starts at its first convolution (the VAE encode, cuDNN) and ends
  where the next starts, so the time from one step's start to the next is
  the loop's wall time per step, data loading, launches and syncs
  included. The ``STEPS`` steps after ``WARMUP`` are read;
- busy: the union of the step's kernel intervals; idle: the rest of its
  wall time, each gap charged to the stage of the kernel after it. The
  idle after the step's last optimizer kernel is ``between steps`` (the
  loop between steps: the next batch, its host-to-device copy, which
  waits for the device, and the launches up to the first convolution);
  the idle before it lies within the step (launches the device waits
  for);
- the stages follow the kernels' order within a step: the VAE encode ends
  at the step's last convolution; the optimizer runs from the first to the
  last ``multi_tensor_apply`` (foreach) kernel; the DiT forward, its
  recompute and the backward lie between the two, by kernel class; what
  runs after the optimizer (the next batch's copy and cast) is
  ``between steps``.

Prints one JSON line and writes it, with the Chrome trace, to ``--out``
(default ``saved_info/profile/``). The profiler's own cost per kernel
launch is in the numbers; compare the wall time per step with
``chip_smoke.py``'s untraced ``train`` line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
from collections import defaultdict

import torch

WARMUP, STEPS = 3, 8  # steps left out, then steps read

K3, K1 = "K3 attention_small_bwd", "K1 attention_small"
K5 = "K5 block_train_fwd"
CONV, MATMUL, OPT = "convolution (cuDNN)", "matmul", "optimizer (foreach)"
DIT_CLASSES = (MATMUL, K1, K3, K5)
# kernel name -> class, first match wins: a key is a tuple of lower-case
# substrings that must all be in the name. K5's forward is this package's
# GEMM (``lfm::sm90::gemm_sm90_kernel``; ``gemm_nt_kernel`` in an older
# checkout's trace) and LayerNorm kernels and its attention that normalises
# p before rounding it (``lfm::sm90::attn_whole_kernel<64, true>``; K1's is
# ``false>``; f32 K1 is ``lfm::row32::attn_row_kernel`` at T <= 256 and D
# 56-80, ``lfm::long32::flash_f32_kernel`` past it (f32 K4's kernel, which a
# train step past the gate also runs), else ``attn_small_kernel`` or
# ``attn_short_f32_kernel``); K3 is
# ``lfm::sm90::attn_bwd_dq_kernel`` and ``attn_bwd_dkdv_kernel`` (bf16),
# ``lfm::row32::attn_row_bwd_dq_kernel`` and ``attn_row_bwd_dkdv_kernel``
# (f32 at T <= 256), ``lfm::long32::attn_long_bwd_dq_kernel`` and the row
# kernels' ``attn_row_bwd_dkdv_kernel`` (f32 past it; ``lfm::attn_bwd_*``
# in an older checkout's trace)
CLASSES = (
    (K5, (("lfm::sm90::gemm_sm90_kernel",), ("lfm::sm90::gemm_nt_kernel",),
          ("lfm::ln_modulate_kernel",), ("lfm::sm90::attn_", "true>"))),
    (K3, (("attn_bwd",), ("attn_row_bwd",), ("attn_long_bwd",))),
    (K1, (("lfm::sm90::attn_",), ("attn_small_kernel",), ("attn_short_f32_kernel",),
          ("attn_row_kernel",), ("flash_f32_kernel",))),
    (CONV, (("cudnn",), ("implicit_gemm",), ("conv",))),
    (MATMUL, (("nvjet",), ("gemm",), ("cutlass",), ("cublas",))),
    (OPT, (("multi_tensor_apply",),)),
    ("copy / cast", (("copy_kernel",),)),
    ("reduction", (("reduce_kernel",),)),
)


def _classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(all(k in low for k in key) for key in keys):
            return cls
    return "elementwise / other"


def _split_steps(kernels):
    """Kernels (sorted by start) -> one list per train step. A step starts
    at its first convolution; what runs before the first step is set-up."""
    steps, seen_opt = [], False
    for e in kernels:
        cls = _classify(e.name)
        if cls == CONV and (not steps or seen_opt):
            steps.append([])
            seen_opt = False
        if steps:
            steps[-1].append(e)
            seen_opt = seen_opt or cls == OPT
    return steps


def _stage_names(step) -> list:
    """The stage of each kernel of one step (see the module docstring)."""
    classes = [_classify(k.name) for k in step]
    last_conv = max(i for i, c in enumerate(classes) if c == CONV)
    opt = [i for i, c in enumerate(classes) if c == OPT]
    names = []
    for i, c in enumerate(classes):
        if i <= last_conv:
            names.append("vae_encode")
        elif i > opt[-1]:
            names.append("between steps")
        elif i >= opt[0]:
            names.append("optimizer")
        else:
            names.append("dit " + (c if c in DIT_CLASSES else "other"))
    return names


def _fused_steps(config, dataset, vae, dev, steps: int) -> None:
    """``steps`` train steps through the fused blocks: the model, optimizer,
    EMA, batches and draws that ``train(...)`` would use, from the same
    fresh initialisation."""
    from lfm_tpu_torch.data import DataLoader
    from lfm_tpu_torch.nn.dit_fused import dit_fused_model_apply
    from lfm_tpu_torch.nn.factory import create_network
    from lfm_tpu_torch.nn.init import dit_init_
    from lfm_tpu_torch.train.state import create_train_state, make_optimizer
    from lfm_tpu_torch.train.train import make_train_step

    tc = config.train
    model = create_network(config.model, dtype=torch.bfloat16,
                           use_flash=config.model.use_flash_attention, device=dev)
    dit_init_(model, tc.seed)
    model.train()
    vae.to(dev).eval().requires_grad_(False)
    loader = DataLoader(dataset, tc.batch_size, shuffle=True, drop_last=True, seed=tc.seed)
    loader.set_epoch(0)
    state = create_train_state(model)
    step = make_train_step(
        model, make_optimizer(tc, tc.steps_per_epoch or max(len(loader), 1)),
        model_apply=dit_fused_model_apply(model), ema_decay=tc.ema_decay, use_ema=tc.use_ema,
        encode_fn=vae.encode_sample, scale_factor=config.scale_factor, seed=tc.seed + 1)
    for _, batch in zip(range(steps), loader):
        step(state, {"x": torch.from_numpy(batch["x"]).to(dev)})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="profile_train")
    p.add_argument("--out", type=str, default="saved_info/profile")
    p.add_argument("--fused", action="store_true",
                   help="train through dit_fused_model_apply (K5) instead of the module")
    p.add_argument("--precision", choices=("bf16", "f32"), default="bf16",
                   help="the module path's compute dtype (the fused blocks are bf16)")
    args = p.parse_args(argv)
    if args.fused and args.precision != "bf16":
        p.error("--fused runs bf16 blocks only")
    if not torch.cuda.is_available():
        print("profile_train: CUDA is not available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from lfm_tpu_torch.core.config import get_preset
    from lfm_tpu_torch.data import SyntheticImageDataset
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.train.loop import train
    from lfm_tpu_torch.vae.autoencoder_kl import create_vae

    dev = torch.device("cuda")
    total = WARMUP + STEPS + 1
    preset = get_preset("celeb256_dit")
    batch = preset.train.batch_size
    vae = create_vae(dtype=torch.bfloat16, device=dev)
    seeded_init_(vae, 1)
    dataset = SyntheticImageDataset(n=batch * (total + 1), image_size=256)
    work = tempfile.mkdtemp(prefix="profile_train_")
    try:
        config = dataclasses.replace(preset, output_dir=work, train=dataclasses.replace(
            preset.train, precision=args.precision))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if args.fused:
                _fused_steps(config, dataset, vae, dev, total)
            else:
                train(config, dataset=dataset, vae=vae, device=dev, max_steps=total,
                      log_fn=lambda line: None)
            torch.cuda.synchronize()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    steps = _split_steps(kernels)
    if len(steps) != total:
        print(f"profile_train: found {len(steps)} steps in the trace, expected {total}",
              file=sys.stderr)
        return 1
    read = range(WARMUP, WARMUP + STEPS)
    wall = 0.0
    by_stage, idle_by_stage, by_class = defaultdict(float), defaultdict(float), defaultdict(float)
    for i in read:
        step, nxt = steps[i], steps[i + 1][0].time_range.start
        wall += nxt - step[0].time_range.start
        end = step[0].time_range.start
        # the device idles before a kernel from the end of the kernels before it
        for k, stage in zip(step, _stage_names(step)):
            a, b = k.time_range.start, k.time_range.end
            idle_by_stage[stage] += max(a - end, 0.0)
            by_stage[stage] += b - a
            by_class[_classify(k.name)] += b - a
            end = max(end, b)
        idle_by_stage["between steps"] += max(nxt - end, 0.0)
    idle = sum(idle_by_stage.values())
    between = idle_by_stage["between steps"]
    ms = lambda us: us / STEPS / 1e3  # noqa: E731  per step
    line = {
        "phase": "profile_train", "preset": "celeb256_dit",
        "path": "fused (K5)" if args.fused else "module", "precision": args.precision,
        "steps_read": STEPS,
        "warmup_steps": WARMUP, "batch": batch,
        "wall_ms_per_step": ms(wall), "device_busy_ms_per_step": ms(wall - idle),
        "device_idle_share": idle / wall,
        "idle_between_steps_ms": ms(between), "idle_within_steps_ms": ms(idle - between),
        "idle_ms_per_step_by_stage": {k: ms(v) for k, v in idle_by_stage.items()},
        "kernels_per_step": sum(len(steps[i]) for i in read) / STEPS,
        "ms_per_step_by_stage": {k: ms(v) for k, v in by_stage.items()},
        "ms_per_step_by_class": {k: ms(v) for k, v in
                                 sorted(by_class.items(), key=lambda kv: -kv[1])},
        "device": torch.cuda.get_device_name(0),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    print(json.dumps(line), flush=True)
    os.makedirs(args.out, exist_ok=True)
    stem = "profile_train" + ("_fused" if args.fused else "") + (
        "_f32" if args.precision == "f32" else "")
    with open(os.path.join(args.out, f"{stem}.json"), "w") as f:
        f.write(json.dumps(line, indent=1))
    prof.export_chrome_trace(os.path.join(args.out, f"{stem}_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
