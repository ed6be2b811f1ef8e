"""Seconds per step of the celeb256_dit train loop on the card.

    python -m lfm_tpu_torch.tools.bench_train [--steps 6] [--precision bf16] [--remat R]

or, to time another checkout's package through the same loop and inputs
(its kernels are built in that checkout):

    PYTHONPATH=<other checkout> python <this checkout>/lfm_tpu_torch/tools/bench_train.py

Runs ``train(...)`` (train/loop.py) on the celeb256_dit preset: DiT-L/2 at
full width and depth, batch 32, grad checkpointing and EMA as the preset
sets them, with ``precision="f32"`` (f32 compute on f32 masters, every
attention through f32 K1 and K3; ``--precision bf16``: the preset's bf16
compute, K1 and K3 in bf16) and, with ``--remat R``, the DiT's remat
policy R instead of the preset's (``none``, ``full``, ``dots``,
``all_dots``, ``dots_attn``; nn/dit.py), from seeded non-zero weights given
as a ``model_0.pth`` (``seeded_init_`` of a bf16 DiT-L/2, as chip_smoke.py
makes them), with a seeded full-width VAE encoder over synthetic 256^2
images, for 1 + ``steps`` steps below one epoch. The loop logs, and so
waits for the loss, after step 1; the time from that log call to the end of
the run, after a sync, over ``steps`` is the seconds per step. Prints one
JSON line: seconds per step, images/s, peak memory, step 1's loss, the
attention kernels' launches (by dtype where the package counts them) and
the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

SEED = 0
# --remat: the choice -> the DiT's remat_policy (``none`` turns remat off)
REMAT = {"none": None, "full": None, "dots": "dots", "all_dots": "all_dots",
         "dots_attn": "dots_attn"}


def with_remat(tc, remat):
    """``tc`` (a TrainConfig) under the ``--remat`` choice, or as it is."""
    if not remat:
        return tc
    return dataclasses.replace(tc, use_grad_checkpointing=remat != "none",
                               remat_policy=REMAT[remat])


def save_seeded_model(config, path: str, device) -> None:
    """The bf16 DiT of ``config`` with ``seeded_init_(model, SEED)`` weights,
    saved as a ``model_0.pth`` (with its pos_embed, as the reference saves
    one)."""
    from lfm_tpu_torch.nn.factory import create_network
    from lfm_tpu_torch.nn.init import seeded_init_

    model = create_network(config.model, dtype=torch.bfloat16,
                           use_flash=config.model.use_flash_attention, device=device)
    seeded_init_(model, SEED)
    torch.save({"pos_embed": model.pos_embed.cpu(),
                **{k: v.cpu() for k, v in model.state_dict().items()}}, path)


def attention_counters() -> dict:
    from lfm_tpu_torch.kernels import flash_attention as fa

    return {"attention_small": fa.ATTENTION_SMALL, "attention_small_bwd": fa.ATTENTION_SMALL_BWD,
            "flash_attention": fa.FLASH_ATTENTION}


def timed_train(config, dataset, vae, device, steps: int) -> dict:
    """``train(config, ...)`` for 1 + ``steps`` steps; the attention
    counters are reset just before and read just after. Returns the state
    and the measurements."""
    from lfm_tpu_torch.train.loop import train

    counters = attention_counters()
    for c in counters.values():
        # a checkout before the counters had reset() (and by_dtype) is timed
        # through this loop too
        if hasattr(c, "reset"):
            c.reset()
        else:
            c.count = 0
    logs = []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    state = train(config, dataset=dataset, vae=vae, device=device, max_steps=1 + steps,
                  log_fn=lambda line: logs.append((time.time(), line)))
    torch.cuda.synchronize()
    t_end = time.time()
    lines = [(t, line) for t, line in logs if "Loss: " in line]
    if len(lines) != 1:
        raise AssertionError(f"train: expected one log line, after step 1; got {lines}")
    t_log, line = lines[0]
    sec = (t_end - t_log) / steps
    return {"state": state, "steps": state.step, "seconds_per_step": sec,
            "images_per_s": config.train.batch_size / sec,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "loss_step1": float(re.search(r"Loss: (\S+),", line).group(1)),
            "launches": {name: c.count for name, c in counters.items()},
            "launches_by_dtype": {name: dict(getattr(c, "by_dtype", {}))
                                  for name, c in counters.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_train")
    p.add_argument("--steps", type=int, default=6, help="timed steps after the first")
    p.add_argument("--precision", choices=("f32", "bf16"), default="f32")
    p.add_argument("--remat", choices=tuple(REMAT), default=None,
                   help="the DiT's remat policy (default: the preset's)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_train: CUDA is not available", file=sys.stderr)
        return 1
    import lfm_tpu_torch
    from lfm_tpu_torch.core.config import get_preset
    from lfm_tpu_torch.data import SyntheticImageDataset
    from lfm_tpu_torch.nn.init import seeded_init_
    from lfm_tpu_torch.vae.autoencoder_kl import create_vae

    dev = torch.device("cuda")
    preset = get_preset("celeb256_dit")
    batch = preset.train.batch_size
    work = tempfile.mkdtemp(prefix="bench_train_")
    try:
        ckpt = os.path.join(work, "model_0.pth")
        save_seeded_model(preset, ckpt, dev)
        tc = dataclasses.replace(preset.train, model_ckpt=ckpt, precision=args.precision)
        config = dataclasses.replace(preset, output_dir=work, train=with_remat(tc, args.remat))
        vae = create_vae(dtype=torch.bfloat16, device=dev)
        seeded_init_(vae, SEED + 1)
        dataset = SyntheticImageDataset(n=batch * (args.steps + 3), image_size=256, seed=SEED)
        res = timed_train(config, dataset, vae, dev, args.steps)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del res["state"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(json.dumps({"package": lfm_tpu_torch.__file__, "card": smi.stdout.strip(),
                      "preset": "celeb256_dit", "precision": args.precision,
                      "remat": args.remat or "preset", "batch": batch,
                      "timed_steps": args.steps, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
