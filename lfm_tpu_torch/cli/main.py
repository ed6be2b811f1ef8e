"""Command-line entry point of the port: the ``sample`` and ``train``
subcommands.

    python -m lfm_tpu_torch.cli.main sample --preset celeb256_dit
    python -m lfm_tpu_torch.cli.main sample --preset celeb256_adm
    python -m lfm_tpu_torch.cli.main train --preset celeb256_dit --dataset synthetic

``sample`` builds the preset's network in bf16 with attention through the
attention kernels, as ``lfm_tpu.cli.main sample`` does: a DiT (fused DiT
blocks unless ``--no_fused_dit``; w8a8 int8 blocks with ``--int8_dit``) or,
with ``use_origin_adm``, the ADM UNet.
It samples one batch and writes the images in [0, 1] as a ``.npy``
(N, H, W, 3) float32 file. ``--ckpt`` takes a reference ``model_{E}.pth``
(with or without the DDP ``module.`` prefix, and a DiT's fixed
``pos_embed``), ``--vae_ckpt`` a diffusers AutoencoderKL checkpoint
(``.bin`` / ``.pth`` / ``.safetensors``, either attention naming). Without
them it warns and uses seeded random weights (every tensor non-zero). Both
subcommands take the JAX CLI's model overrides (``--model_type
--image_size --nf --ch_mult --attn_resolutions --num_res_blocks
--use_origin_adm --num_classes --label_dropout --scale_factor --dataset
--exp``), on top of ``--preset`` or ``--argfile``.

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


def _model_flags(p: argparse.ArgumentParser) -> None:
    """The config flags both subcommands share (lfm_tpu/cli/main.py:33-50)."""
    for name, typ in (("preset", str), ("argfile", str), ("exp", str), ("dataset", str),
                      ("model_type", str), ("image_size", int), ("num_classes", int),
                      ("label_dropout", float), ("nf", int), ("num_res_blocks", int),
                      ("scale_factor", float)):
        p.add_argument(f"--{name}", type=typ, default=None)
    p.add_argument("--ch_mult", nargs="+", type=int, default=None)
    p.add_argument("--attn_resolutions", nargs="+", type=int, default=None)
    p.add_argument("--use_origin_adm", action="store_true", default=None)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lfm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    _train_parser(sub.add_parser("train"))
    s = sub.add_parser("sample")
    _model_flags(s)
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
    s.add_argument("--int8_dit", action="store_true",
                   help="w8a8 int8 DiT sampling (nn/dit_int8.py; wins over the fused "
                        "blocks)")
    s.add_argument("--device", type=str, default=None,
                   help="default: the card; pass cpu to run on the CPU")
    s.add_argument("--out", type=str, default=None,
                   help="output .npy (default ./samples_torch_<dataset>_<method>.npy)")
    return p


def _train_parser(t: argparse.ArgumentParser) -> None:
    """The flags of ``lfm_tpu.cli.main train`` that one device honours
    (lfm_tpu/cli/main.py:33-102)."""
    _model_flags(t)
    for name, typ in (("datadir", str), ("batch_size", int), ("seed", int),
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
    """The preset or argfile with the model overrides applied, and ``--exp``,
    ``--dataset`` and ``--scale_factor`` (lfm_tpu/cli/main.py:187-265)."""
    if args.preset:
        config = get_preset(args.preset)
    else:
        config = load_argfile(args.argfile) if args.argfile else Config()
    model = _over(config.model, model_type=args.model_type, image_size=args.image_size,
                  num_classes=args.num_classes, label_dropout=args.label_dropout, nf=args.nf,
                  ch_mult=tuple(args.ch_mult) if args.ch_mult else None,
                  attn_resolutions=tuple(args.attn_resolutions) if args.attn_resolutions
                  else None,
                  num_res_blocks=args.num_res_blocks, use_origin_adm=args.use_origin_adm)
    config = dataclasses.replace(config, model=model)
    return _over(config, exp=args.exp, dataset=args.dataset, scale_factor=args.scale_factor)


def _resolve_train_config(args) -> Config:
    config = _base_config(args)
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
    return dataclasses.replace(config, train=train_cfg, data=data, mesh=mesh)


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
                   use_fused_dit=False if args.no_fused_dit else None,
                   use_int8_dit=True if args.int8_dit else None)
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
        name = "origin-ADM UNet" if config.model.use_origin_adm else config.model.model_type
        print(f"[warn] no --ckpt; using seeded random {name} weights", file=sys.stderr)
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
