"""Command-line entry point of the port: the ``sample`` subcommand.

    python -m lfm_tpu_torch.cli.main sample --preset celeb256_dit

Builds a bf16 DiT with attention through the ``attention_small`` kernel, as
``lfm_tpu.cli.main sample`` does, samples one batch (fused DiT blocks unless
``--no_fused_dit``) and writes the images in [0, 1] as a ``.npy`` (N, H, W, 3)
float32 file. Without ``--ckpt`` / ``--vae_ckpt`` it warns and uses seeded
random weights (every tensor non-zero). ``--ckpt`` takes a state dict saved
with ``torch.save`` in this package's key names. The other subcommands of the
JAX CLI (train, fid, nfe, time, downstream tasks) are later slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from lfm_tpu_torch.core.config import Config, get_preset, load_argfile
from lfm_tpu_torch.core.device import resolve_device
from lfm_tpu_torch.core.rng import SampleRNG
from lfm_tpu_torch.nn.factory import create_network
from lfm_tpu_torch.nn.init import seeded_init_
from lfm_tpu_torch.sample.sample import make_sampler, noise_and_labels
from lfm_tpu_torch.vae.autoencoder_kl import create_vae


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lfm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("sample")
    s.add_argument("--preset", type=str, default=None)
    s.add_argument("--argfile", type=str, default=None)
    s.add_argument("--ckpt", type=str, default=None)
    s.add_argument("--vae_ckpt", type=str, default=None)
    s.add_argument("--method", type=str, default=None)
    s.add_argument("--num_steps", "--steps", type=int, default=None, dest="num_steps")
    s.add_argument("--atol", type=float, default=None)
    s.add_argument("--rtol", type=float, default=None)
    s.add_argument("--cfg_scale", type=float, default=None)
    s.add_argument("--batch_size", type=int, default=None)
    s.add_argument("--seed", type=int, default=None)
    s.add_argument("--no_fused_dit", action="store_true")
    s.add_argument("--device", type=str, default=None,
                   help="default: the card; pass cpu to run on the CPU")
    s.add_argument("--out", type=str, default=None,
                   help="output .npy (default ./samples_torch_<dataset>_<method>.npy)")
    return p


def _resolve_config(args) -> Config:
    if args.preset:
        config = get_preset(args.preset)
    elif args.argfile:
        config = load_argfile(args.argfile)
    else:
        config = Config()
    kw = dict(method=args.method, num_steps=args.num_steps, atol=args.atol,
              rtol=args.rtol, cfg_scale=args.cfg_scale, batch_size=args.batch_size,
              seed=args.seed)
    kw = {k: v for k, v in kw.items() if v is not None}
    if args.no_fused_dit:
        kw["use_fused_dit"] = False
    return dataclasses.replace(config, sample=dataclasses.replace(config.sample, **kw))


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = _build_parser().parse_args(argv)
    config = _resolve_config(args)
    device = resolve_device(args.device)
    model = create_network(config.model, dtype=torch.bfloat16,
                           use_flash=config.model.use_flash_attention, device=device)
    vae = create_vae(dtype=torch.bfloat16, device=device)
    params = vae_params = None
    if args.ckpt:
        params = torch.load(args.ckpt, map_location=device, weights_only=True)
    else:
        print("[warn] no --ckpt; using seeded random DiT weights", file=sys.stderr)
        seeded_init_(model, seed=0)
    if args.vae_ckpt:
        vae_params = torch.load(args.vae_ckpt, map_location=device, weights_only=True)
    else:
        print("[warn] no --vae_ckpt; using seeded random VAE weights", file=sys.stderr)
        seeded_init_(vae, seed=1)

    sc = config.sample
    sampler = make_sampler(config, model, params, vae, vae_params, device=device)
    rng = SampleRNG(seed=sc.seed, num_samples=sc.n_sample)
    noise, y = noise_and_labels(config, rng, range(sc.batch_size), device=device)
    out = sampler(noise, y)
    path = args.out or f"./samples_torch_{config.dataset}_{sc.method}.npy"
    np.save(path, out.images.cpu().numpy())
    print(f"Samples are saved at {path} (NFE {out.nfe:.0f})")
    return path


if __name__ == "__main__":
    main()
