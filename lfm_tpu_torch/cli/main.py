"""Command-line entry point of the port: the ``sample`` and ``train``
subcommands.

    python -m lfm_tpu_torch.cli.main sample --preset celeb256_dit
    python -m lfm_tpu_torch.cli.main train --preset celeb256_dit --dataset synthetic

``sample`` builds a bf16 DiT with attention through the ``attention_small``
kernel, as ``lfm_tpu.cli.main sample`` does, samples one batch (fused DiT
blocks unless ``--no_fused_dit``) and writes the images in [0, 1] as a
``.npy`` (N, H, W, 3) float32 file. ``--ckpt`` takes a reference
``model_{E}.pth`` (with or without the DDP ``module.`` prefix and its fixed
``pos_embed``), ``--vae_ckpt`` a diffusers AutoencoderKL checkpoint
(``.bin`` / ``.pth`` / ``.safetensors``, either attention naming). Without
them it warns and uses seeded random weights (every tensor non-zero).

``train`` runs ``train/loop.py::train`` on one card with the JAX CLI's
single-device flags; mesh flags other than 1 raise. Images are encoded by
the frozen VAE (``--vae_ckpt``, else seeded random weights) unless the
dataset is pre-encoded latents (``latent_*``, ``synthetic_latent``). The
datasets ported so far are ``synthetic``, ``synthetic_latent`` and
``latent_*``. The other subcommands of the JAX CLI (fid, nfe, time,
downstream tasks) are later slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from lfm_tpu_torch.core.checkpoint import reference_state_dict
from lfm_tpu_torch.core.config import Config, get_preset, load_argfile
from lfm_tpu_torch.core.device import resolve_device
from lfm_tpu_torch.core.rng import SampleRNG
from lfm_tpu_torch.nn.factory import create_network
from lfm_tpu_torch.nn.init import seeded_init_
from lfm_tpu_torch.sample.sample import make_sampler, noise_and_labels
from lfm_tpu_torch.vae.autoencoder_kl import create_vae
from lfm_tpu_torch.vae.convert import load_vae_state_dict


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lfm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    _train_parser(sub.add_parser("train"))
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


def _train_parser(t: argparse.ArgumentParser) -> None:
    """The flags of ``lfm_tpu.cli.main train`` that one device honours
    (lfm_tpu/cli/main.py:33-102)."""
    for name, typ in (("preset", str), ("argfile", str), ("exp", str), ("dataset", str),
                      ("datadir", str), ("model_type", str), ("image_size", int),
                      ("num_classes", int), ("label_dropout", float),
                      ("scale_factor", float), ("batch_size", int), ("seed", int),
                      ("vae_ckpt", str), ("lr", float), ("num_epoch", int),
                      ("ema_decay", float), ("save_content_every", int),
                      ("save_ckpt_every", int), ("plot_every", int), ("model_ckpt", str),
                      ("precision", str), ("max_steps", int), ("remat_policy", str)):
        t.add_argument(f"--{name}", type=typ, default=None)
    for name in ("no_lr_decay", "use_ema", "use_grad_checkpointing", "save_content", "resume"):
        t.add_argument(f"--{name}", action="store_true", default=None)
    for name in ("dp", "fsdp", "tp", "sp", "pp", "pp_chunks"):
        t.add_argument(f"--{name}", type=int, default=None,
                       help="mesh axis; only 1 (dp: -1 or 1) is ported")
    t.add_argument("--device", type=str, default=None,
                   help="default: the card; pass cpu to run on the CPU")


def _over(dc, **kw):
    """``dc`` with the fields that are not None replaced."""
    kw = {k: v for k, v in kw.items() if v is not None}
    return dataclasses.replace(dc, **kw) if kw else dc


def _base_config(args) -> Config:
    if args.preset:
        return get_preset(args.preset)
    return load_argfile(args.argfile) if args.argfile else Config()


def _resolve_train_config(args) -> Config:
    config = _base_config(args)
    model = _over(config.model, model_type=args.model_type, image_size=args.image_size,
                  num_classes=args.num_classes, label_dropout=args.label_dropout)
    train_cfg = _over(
        config.train, lr=args.lr, num_epoch=args.num_epoch, no_lr_decay=args.no_lr_decay,
        use_ema=args.use_ema, ema_decay=args.ema_decay,
        use_grad_checkpointing=args.use_grad_checkpointing, save_content=args.save_content,
        save_content_every=args.save_content_every, save_ckpt_every=args.save_ckpt_every,
        plot_every=args.plot_every, resume=args.resume, precision=args.precision,
        batch_size=args.batch_size, seed=args.seed, model_ckpt=args.model_ckpt,
        remat_policy=args.remat_policy)
    data = _over(config.data, dataset=args.dataset, datadir=args.datadir)
    mesh = _over(config.mesh, dp=args.dp, fsdp=args.fsdp, tp=args.tp, sp=args.sp, pp=args.pp,
                 pp_chunks=args.pp_chunks)
    config = dataclasses.replace(config, model=model, train=train_cfg, data=data, mesh=mesh)
    return _over(config, exp=args.exp, dataset=args.dataset, scale_factor=args.scale_factor)


def _load_vae(path: Optional[str], device: torch.device):
    vae = create_vae(dtype=torch.bfloat16, device=device)
    if path:
        vae.load_state_dict(load_vae_state_dict(path))
    else:
        print("[warn] no --vae_ckpt; using seeded random VAE weights", file=sys.stderr)
        seeded_init_(vae, seed=1)
    return vae


def train_main(args) -> None:
    from lfm_tpu_torch.train.loop import train

    config = _resolve_train_config(args)
    device = resolve_device(args.device)
    vae = None if "latent" in config.dataset else _load_vae(args.vae_ckpt, device)
    train(config, vae=vae, device=device, max_steps=args.max_steps)


def _resolve_config(args) -> Config:
    config = _base_config(args)
    sample = _over(config.sample, method=args.method, num_steps=args.num_steps,
                   atol=args.atol, rtol=args.rtol, cfg_scale=args.cfg_scale,
                   batch_size=args.batch_size, seed=args.seed,
                   use_fused_dit=False if args.no_fused_dit else None)
    return dataclasses.replace(config, sample=sample)


def main(argv: Optional[Sequence[str]] = None) -> Optional[str]:
    args = _build_parser().parse_args(argv)
    if args.cmd == "train":
        return train_main(args)
    config = _resolve_config(args)
    device = resolve_device(args.device)
    model = create_network(config.model, dtype=torch.bfloat16,
                           use_flash=config.model.use_flash_attention, device=device)
    vae = _load_vae(args.vae_ckpt, device)
    params = None
    if args.ckpt:
        params = reference_state_dict(args.ckpt)
    else:
        print("[warn] no --ckpt; using seeded random DiT weights", file=sys.stderr)
        seeded_init_(model, seed=0)

    sc = config.sample
    sampler = make_sampler(config, model, params, vae, None, device=device)
    rng = SampleRNG(seed=sc.seed, num_samples=sc.n_sample)
    noise, y = noise_and_labels(config, rng, range(sc.batch_size), device=device)
    out = sampler(noise, y)
    path = args.out or f"./samples_torch_{config.dataset}_{sc.method}.npy"
    np.save(path, out.images.cpu().numpy())
    print(f"Samples are saved at {path} (NFE {out.nfe:.0f})")
    return path


if __name__ == "__main__":
    main()
