"""Command-line entry point of the port: the ``sample``, ``fid``, ``nfe``,
``time`` and ``train`` subcommands (the reference's test_flow_latent.py
modes and train_flow_latent.py).

    python -m lfm_tpu_torch.cli.main sample --preset celeb256_dit
    python -m lfm_tpu_torch.cli.main fid --argfile test_args/imnet_adm.txt --real_img_dir stats.npz
    python -m lfm_tpu_torch.cli.main nfe --preset ffhq_adm
    python -m lfm_tpu_torch.cli.main time --preset celeb256_dit
    python -m lfm_tpu_torch.cli.main train --preset celeb256_dit --dataset synthetic

The sampling subcommands build the preset's network in bf16 with attention
through the attention kernels, as ``lfm_tpu.cli.main`` does: a DiT (fused
DiT blocks unless ``--no_fused_dit``, and with ``--fused_dit`` even where
the argfile or preset turned them off; w8a8 int8 blocks with
``--int8_dit``), with ``use_origin_adm`` the ADM UNet (with ``layout`` its
SpatialTransformer variant), else EDM's networks (DhariwalUNet, its context
variant ``adm_context``, SongUNet's ``ncsn++`` and ``ddpm++``).
``--ckpt`` takes a reference ``model_{E}.pth`` (with or without the DDP
``module.`` prefix, and a DiT's fixed ``pos_embed``); without it the
experiment's ``model_{epoch_id}.pth`` is read where it exists, else they
warn and use seeded random weights (every tensor non-zero). ``--vae_ckpt``
takes a diffusers AutoencoderKL checkpoint (``.bin`` / ``.pth`` /
``.safetensors``, either attention naming), else seeded random weights.

* ``sample`` samples one batch and writes the JAX CLI's image grid,
  ``./samples_{dataset}_{method}_{atol}_{rtol}[_cfg{scale}].jpg``, or with
  ``--use_karras_samplers`` ``./samples_{dataset}_{method}_{num_steps}
  [_cfg{scale}].jpg`` (a JPEG, which needs Pillow), or with ``--out F`` the
  images in [0, 1] as a ``.npy`` (N, H, W, 3) float32 file.
* ``fid`` generates ``--n_sample`` images (sample/sharded.py) and prints
  ``FID = x`` against the statistics file ``--real_img_dir`` (the
  reference's ``.npy`` / ``.npz`` format), appending ``Epoch = E, FID = x``
  to ``--output_log``. ``--inception_ckpt`` takes pytorch-fid's Inception
  weights, else seeded random ones (a protocol check, not image quality);
  ``--save_dir`` writes each image as ``{index}.jpg``, which needs PIL.
* ``nfe`` samples ``--n_sample`` (default 300) single images and prints
  ``Average NFE over N trials: K``.
* ``time`` samples one image once, then ``--n_sample`` (default 300) times
  more, each timed to the images on the host, and prints
  ``Inference time: m+/-s ms``.

They take the JAX CLI's model overrides (``--model_type --image_size --nf
--ch_mult --attn_resolutions --num_res_blocks --use_origin_adm
--num_classes --label_dropout --scale_factor --dataset --datadir --exp``) on top of
``--preset`` or ``--argfile``, and its solver flags: ``--method``,
``--steps``, ``--atol``, ``--rtol``, ``--cfg_scale``,
``--use_karras_samplers`` (the Karras euler / heun loops over ``--steps``
sigmas; an argfile with ``STEPS`` sets it) and ``--eval_noise`` (the
adaptive noise floor, a float or ``auto``; by default ``auto`` for a bf16
model under dopri8 only). ``--generator`` takes ``determ`` and
``determ-indiv``, which ``SampleRNG`` realises alike, and raises on the
stateful ``dummy`` (item 9). ``sample --sp N`` / ``--pp N``
(``--pp_chunks V``) samples over the ranks of the job: sequence-parallel
(a DiT's ring attention, a UNet's row-sharded forward; sample/sp.py) or
pipeline-parallel (a DiT's blocks in stages; sample/pp.py), with ``--sp``
taken where both are given, as in JAX; one process asked for either raises
the mesh's rank-count error. ``fid``, ``nfe`` and ``time`` parse the three
flags and ignore them, as JAX's do.

``train`` runs ``train/loop.py::train`` with the JAX CLI's flags, for
every preset (the DiTs, the origin ADMs, EDM's DhariwalUNets), over the
``--dp/--fsdp/--tp/--sp/--pp`` mesh of its ranks (``--pp`` > 1 stages a
DiT's blocks, ``--pp_chunks`` interleaved; ``--sp`` only lays out the
mesh, as in JAX). It reads the preset's
dataset from ``--datadir`` (data/__init__.py: image folders, CIFAR-10,
the NVAE / LSUN / image LMDBs, latents; ``--dataset synthetic`` or
``synthetic_latent`` for seeded data). Images are encoded by the frozen
VAE (``--vae_ckpt``, else seeded random weights) unless the dataset is
pre-encoded latents (``latent_*``, ``synthetic_latent``).

Several GPUs: one process per GPU, started by torchrun (the world comes
from its environment) or by hand with ``--coordinator host:port
--num_procs N --process_id R`` on each. Only ``train`` and ``fid`` take
more than one process (``_MULTIPROC_CMDS``, as JAX's CLI), and ``sample``
where ``--sp`` or ``--pp`` above 1 lays its mesh over them (in JAX one
process drives every device); the others exit with JAX's message.
``train`` splits each batch over the data axis, ``fid`` each sampling
batch over every rank, and ``sample`` its batch as its mesh says; rank 0
alone prints, logs and writes files.

    torchrun --nproc_per_node=8 -m lfm_tpu_torch.cli.main train --preset celeb256_dit
    torchrun --nproc_per_node=8 -m lfm_tpu_torch.cli.main fid --preset celeb256_dit \
        --real_img_dir stats.npz
    torchrun --nproc_per_node=2 -m lfm_tpu_torch.cli.main sample --preset celeb256_dit --sp 2
    torchrun --nproc_per_node=2 -m lfm_tpu_torch.cli.main sample --preset celeb256_dit \
        --pp 2 --pp_chunks 2

The downstream subcommands (lfm_tpu/cli/main.py:103-140, 382-466), on one
card, with the JAX CLI's flags:

    python -m lfm_tpu_torch.cli.main train-inpainting --preset celeb256_adm --datadir imgs/
    python -m lfm_tpu_torch.cli.main train-semantic --preset celeb256_adm \
        --seg_dataset celebamask --datadir CelebAMask-HQ/
    python -m lfm_tpu_torch.cli.main test-inpainting --preset celeb256_adm \
        --ckpt model_E.pth --indir imgs/ --maskdir masks/
    python -m lfm_tpu_torch.cli.main test-semantic --preset celeb256_adm --ckpt model_E.pth \
        --seg_dataset celebamask --datadir CelebAMask-HQ/

* ``train-inpainting`` trains the network with 9 input channels on the
  images under ``--datadir`` with LaMa's masks (train/downstream_loops.py);
  ``train-semantic`` with 8 on a segmentation dataset (``--seg_dataset``
  coco, ade20k or celebamask under ``--datadir``) and a
  ``SpatialRescaler(n_stages=3, multiplier=0.5, out_channels=4)`` trained
  with it.
* ``test-inpainting`` writes the composites of the evaluation set
  (``--indir`` ``{i:06d}.jpg``, ``--maskdir`` ``{i:06d}.png``) as
  ``{save_dir}/{dataset}/{i}.jpg``; ``test-semantic`` the samples of
  ``--n_sample`` (default 8) label maps of ``--split`` as
  ``{save_dir}/{i}.jpg``. Both need Pillow to read and write images.
  ``--ckpt`` takes this package's downstream ``model_{E}.pth`` (the
  network and the rescaler) or a reference ``model_{E}.pth`` (the bare
  network; the rescaler keeps its init); without one they warn and keep
  the JAX package's initialisation.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from lfm_tpu_torch.core.checkpoint import reference_state_dict
from lfm_tpu_torch.core.config import Config, get_preset, load_argfile
from lfm_tpu_torch.core.device import resolve_device
from lfm_tpu_torch.core.multihost import (from_torchrun, initialize, is_main_process,
                                          process_count)
from lfm_tpu_torch.core.rng import SampleRNG, seeded_generator
from lfm_tpu_torch.core.sharding import make_mesh, mesh_shape
from lfm_tpu_torch.data.transforms import require_pil
from lfm_tpu_torch.eval.inception import load_inception_params, seeded_inception_state_dict
from lfm_tpu_torch.nn.factory import create_network
from lfm_tpu_torch.nn.init import seeded_init_, unet_init_
from lfm_tpu_torch.sample.sample import make_sampler, noise_and_labels
from lfm_tpu_torch.sample.sharded import compute_fid
from lfm_tpu_torch.train.loop import save_image_grid
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
    # one process per GPU (lfm_tpu/cli/main.py:53-62)
    p.add_argument("--coordinator", type=str, default=None,
                   help="rendezvous address host:port of a multi-process run "
                        "(torchrun's environment takes its place)")
    p.add_argument("--num_procs", type=int, default=None,
                   help="the number of processes, one per GPU")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank in --num_procs")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lfm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    _train_parser(sub.add_parser("train"))
    for name in ("sample", "fid", "nfe", "time"):
        _sample_parser(sub.add_parser(name))
    for name in DOWNSTREAM:
        _downstream_parser(sub.add_parser(name), name)
    return p


DOWNSTREAM = ("train-inpainting", "train-semantic", "test-inpainting", "test-semantic")


def _downstream_parser(p: argparse.ArgumentParser, name: str) -> None:
    """The flags of ``lfm_tpu.cli.main`` ``name`` (lfm_tpu/cli/main.py:
    103-140), and ``--device``."""
    _model_flags(p)
    for flag, typ in (("datadir", str), ("batch_size", int), ("seed", int), ("vae_ckpt", str)):
        p.add_argument(f"--{flag}", type=typ, default=None)
    if name.endswith("semantic"):
        p.add_argument("--seg_dataset", type=str, default="celebamask",
                       choices=["coco", "ade20k", "celebamask"])
    if name.startswith("train"):
        for flag, typ in (("lr", float), ("num_epoch", int), ("max_steps", int)):
            p.add_argument(f"--{flag}", type=typ, default=None)
        for flag in ("use_ema", "save_content"):
            p.add_argument(f"--{flag}", action="store_true", default=None)
    else:
        for flag, typ in (("ckpt", str), ("method", str), ("epoch_id", int)):
            p.add_argument(f"--{flag}", type=typ, default=None)
        p.add_argument("--num_steps", "--steps", type=int, default=None, dest="num_steps")
    if name == "test-inpainting":
        p.add_argument("--indir", type=str, default=None)
        p.add_argument("--maskdir", type=str, default=None)
        p.add_argument("--save_dir", type=str, default="./inpainting_generated_samples")
    if name == "test-semantic":
        p.add_argument("--split", type=str, default="val")
        p.add_argument("--n_sample", type=int, default=None)
        p.add_argument("--save_dir", type=str, default="./semantic_generated_samples")
    p.add_argument("--device", type=str, default=None,
                   help="default: the card; pass cpu to run on the CPU")


def _sample_parser(s: argparse.ArgumentParser) -> None:
    """The flags of ``lfm_tpu.cli.main sample|fid|nfe|time``
    (lfm_tpu/cli/main.py:143-183)."""
    _model_flags(s)
    for name, typ in (("ckpt", str), ("vae_ckpt", str), ("method", str), ("atol", float),
                      ("rtol", float), ("cfg_scale", float), ("batch_size", int), ("seed", int),
                      ("epoch_id", int), ("n_sample", int), ("generator", str),
                      ("real_img_dir", str), ("output_log", str), ("inception_ckpt", str),
                      ("save_dir", str), ("eval_noise", str)):
        s.add_argument(f"--{name}", type=typ, default=None)
    s.add_argument("--num_steps", "--steps", type=int, default=None, dest="num_steps")
    s.add_argument("--use_karras_samplers", action="store_true", default=None)
    s.add_argument("--datadir", type=str, default=None)
    fused = s.add_mutually_exclusive_group()
    fused.add_argument("--fused_dit", action="store_true", default=None,
                       help="fused DiT blocks on, over an argfile or preset that turned "
                            "them off")
    fused.add_argument("--no_fused_dit", action="store_true", default=None)
    s.add_argument("--int8_dit", action="store_true",
                   help="w8a8 int8 DiT sampling (nn/dit_int8.py; wins over the fused "
                        "blocks)")
    s.add_argument("--sp", type=int, default=None,
                   help="sample: sequence-parallel mesh axis over the ranks (ring attention "
                        "over latent rows); fid / nfe / time ignore it, as JAX's")
    s.add_argument("--pp", type=int, default=None,
                   help="sample: pipeline-parallel mesh axis over the ranks (DiT block "
                        "stages)")
    s.add_argument("--pp_chunks", type=int, default=None,
                   help="virtual pipeline stages a rank (interleaved schedule)")
    s.add_argument("--device", type=str, default=None,
                   help="default: the card; pass cpu to run on the CPU")
    s.add_argument("--out", type=str, default=None,
                   help="sample: write the images as this .npy instead of the JAX CLI's "
                        "./samples_<dataset>_<method>_<atol>_<rtol>[_cfg<scale>].jpg grid")


def _train_parser(t: argparse.ArgumentParser) -> None:
    """The flags of ``lfm_tpu.cli.main train`` (lfm_tpu/cli/main.py:33-102)."""
    _model_flags(t)
    for name, typ in (("datadir", str), ("batch_size", int), ("seed", int),
                      ("vae_ckpt", str), ("lr", float), ("num_epoch", int),
                      ("ema_decay", float), ("save_content_every", int),
                      ("save_ckpt_every", int), ("plot_every", int), ("model_ckpt", str),
                      ("precision", str), ("max_steps", int), ("remat_policy", str),
                      ("preempt_check_every", int)):
        t.add_argument(f"--{name}", type=typ, default=None)
    for name in ("no_lr_decay", "use_ema", "use_grad_checkpointing", "save_content", "resume"):
        t.add_argument(f"--{name}", action="store_true", default=None)
    for name in ("dp", "fsdp", "tp"):
        t.add_argument(f"--{name}", type=int, default=None,
                       help="mesh axis over the ranks (dp -1: the ranks the others leave)")
    t.add_argument("--sp", type=int, default=None,
                   help="sequence-parallel mesh axis (lays out the mesh, as in JAX)")
    t.add_argument("--pp", type=int, default=None,
                   help="pipeline-parallel mesh axis (DiT block stages)")
    t.add_argument("--pp_chunks", type=int, default=None,
                   help="virtual pipeline stages a rank (interleaved schedule; checkpoints "
                        "stay canonical)")
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
        remat_policy=args.remat_policy, preempt_check_every=args.preempt_check_every)
    data = _over(config.data, dataset=args.dataset, datadir=args.datadir)
    mesh = _over(config.mesh, dp=args.dp, fsdp=args.fsdp, tp=args.tp, sp=args.sp, pp=args.pp,
                 pp_chunks=args.pp_chunks)
    return dataclasses.replace(config, train=train_cfg, data=data, mesh=mesh)


def _check_mesh(config: Config) -> None:
    """The mesh's rank-count error, before anything is built."""
    m = config.mesh
    mesh_shape(process_count(), m.dp, m.fsdp, m.tp, m.sp, m.pp)


def _load_vae(path: Optional[str], device: torch.device):
    vae = create_vae(dtype=torch.bfloat16, device=device)
    if path:
        vae.load_state_dict(load_vae_state_dict(path))
    else:
        print("[warn] no --vae_ckpt; using seeded random VAE weights", file=sys.stderr)
        seeded_init_(vae, seed=1)
    return vae


def train_main(args):
    """``train``; returns the final TrainState."""
    from lfm_tpu_torch.train.loop import train

    config = _resolve_train_config(args)
    _check_mesh(config)
    device = resolve_device(args.device)
    vae = None if "latent" in config.dataset else _load_vae(args.vae_ckpt, device)
    return train(config, vae=vae, device=device, max_steps=args.max_steps)


# the subcommands with a multi-process story (rank-0 writes, collective
# checkpoints and gathers); the others would repeat the work on every rank
# and race on their output files (lfm_tpu/cli/main.py:361-372)
_MULTIPROC_CMDS = ("train", "fid")


def _sample_mesh(args) -> bool:
    """Whether ``sample`` lays a sequence- or pipeline-parallel mesh over
    the ranks."""
    return args.cmd == "sample" and any((getattr(args, k) or 1) > 1 for k in ("sp", "pp"))


def _join(args) -> None:
    """Join the job of ``--num_procs`` processes, or torchrun's; a
    subcommand outside ``_MULTIPROC_CMDS`` exits with JAX's message, but
    for ``sample`` over an sp or pp mesh."""
    n = args.num_procs
    if n is None and from_torchrun():
        n = int(os.environ["WORLD_SIZE"])
    if not n or n <= 1:
        return
    if args.cmd not in _MULTIPROC_CMDS and not _sample_mesh(args):
        raise SystemExit(
            f"--num_procs > 1 is not supported for '{args.cmd}' (only "
            f"{', '.join(_MULTIPROC_CMDS)} are multi-process aware; "
            "other subcommands would duplicate work on every rank and "
            "race on output files)")
    initialize(args.coordinator, args.num_procs, args.process_id, device=args.device)


def _resolve_config(args) -> Config:
    """The sampling subcommands' config; the flags the port does not
    implement raise instead of being ignored."""
    if args.generator not in (None, "determ", "determ-indiv"):
        # SampleRNG realises both per-sample generators (lfm_tpu/core/rng.py:88-99)
        raise NotImplementedError(f"--generator {args.generator}: only determ and "
                                  "determ-indiv are ported; the stateful dummy generator is "
                                  "ROADMAP Queue 1 item 9")
    config = _base_config(args)
    sample = _over(config.sample, method=args.method, num_steps=args.num_steps,
                   atol=args.atol, rtol=args.rtol, cfg_scale=args.cfg_scale,
                   batch_size=args.batch_size, seed=args.seed, epoch_id=args.epoch_id,
                   n_sample=args.n_sample, generator=args.generator,
                   real_img_dir=args.real_img_dir, output_log=args.output_log,
                   use_karras_samplers=args.use_karras_samplers,
                   use_fused_dit=(False if args.no_fused_dit
                                  else True if args.fused_dit else None),
                   use_int8_dit=True if args.int8_dit else None,
                   eval_noise=(None if args.eval_noise is None
                               else "auto" if args.eval_noise == "auto"
                               else float(args.eval_noise)))
    data = _over(config.data, dataset=args.dataset, datadir=args.datadir)
    mesh = _over(config.mesh, sp=args.sp, pp=args.pp, pp_chunks=args.pp_chunks)
    return dataclasses.replace(config, sample=sample, data=data, mesh=mesh)


def _load_model(config: Config, args, device: torch.device):
    """The bf16 network and its weights: ``--ckpt``, else the experiment's
    ``model_{epoch_id}.pth`` where it exists (lfm_tpu/cli/main.py:268-304),
    else seeded random weights with a warning. Returns (model, state dict
    or None)."""
    m = config.model
    model = create_network(m, dtype=torch.bfloat16, use_flash=m.use_flash_attention,
                           device=device)
    path = args.ckpt or os.path.join(config.exp_path, f"model_{config.sample.epoch_id}.pth")
    if args.ckpt or os.path.isfile(path):
        return model, reference_state_dict(path)
    name = ("origin-ADM UNet" if m.use_origin_adm else m.model_type if m.is_dit
            else "EDM DhariwalUNet")
    print(f"[warn] no --ckpt and no {path}; using seeded random {name} weights",
          file=sys.stderr)
    seeded_init_(model, seed=0)
    return model, None


def _inception_params(path: Optional[str]):
    if path:
        return load_inception_params(path)
    print("[warn] no --inception_ckpt; using seeded random Inception weights (a protocol "
          "check, not image quality)", file=sys.stderr)
    return seeded_inception_state_dict(0)


def main(argv: Optional[Sequence[str]] = None):
    """Runs one subcommand. Returns what it wrote or measured: ``train``,
    ``train-inpainting`` and ``train-semantic`` the final TrainState;
    ``test-inpainting`` and ``test-semantic`` the directory they wrote; ``sample`` the path it wrote; ``fid`` the distance;
    ``nfe`` the NFE of each trial; ``time`` {"ms": each repetition's
    milliseconds, "nfe": the NFE of the warm-up and of each repetition}."""
    args = _build_parser().parse_args(argv)
    _join(args)
    if args.cmd == "train":
        return train_main(args)
    if args.cmd in DOWNSTREAM:
        return downstream_main(args)
    config = _resolve_config(args)
    sc = config.sample
    if args.cmd == "fid" and not sc.real_img_dir:
        raise SystemExit("fid needs --real_img_dir: the dataset's precomputed statistics "
                         "(.npy / .npz)")
    sp_mesh = pp_mesh = None
    m = config.mesh
    if args.cmd == "sample" and (m.sp > 1 or m.pp > 1):
        # the mesh first: one process asked for sp / pp raises here
        mesh = make_mesh(m.dp, m.fsdp, m.tp, m.sp, m.pp)
        sp_mesh = mesh if m.sp > 1 else None
        pp_mesh = mesh if sp_mesh is None else None
    device = resolve_device(args.device)
    model, params = _load_model(config, args, device)
    vae = _load_vae(args.vae_ckpt, device)
    rng = SampleRNG(seed=sc.seed, num_samples=sc.n_sample)

    if args.cmd == "fid":
        fid = compute_fid(config, model, params, vae, None, _inception_params(args.inception_ckpt),
                          stats_path=sc.real_img_dir, save_dir=args.save_dir, device=device)
        # every rank holds the same score; rank 0 reports it
        # (test_flow_latent_ddp.py:146-153)
        if is_main_process():
            print(f"FID = {fid}")
            if sc.output_log:
                with open(sc.output_log, "a") as f:
                    f.write(f"Epoch = {sc.epoch_id}, FID = {fid}\n")
        return fid

    sampler = make_sampler(config, model, params, vae, None, device=device, sp_mesh=sp_mesh,
                           pp_mesh=pp_mesh)
    if args.cmd == "nfe":
        # average NFE over trials at batch 1 (test_flow_latent.py:196-221)
        trials = 300 if args.n_sample is None else args.n_sample
        nfes = [sampler(*noise_and_labels(config, rng, [i], device=device)).nfe
                for i in range(trials)]
        print(f"Average NFE over {trials} trials: {int(sum(nfes) / trials)}")
        return nfes

    if args.cmd == "time":
        # batch-1 latency (test_flow_latent.py:223-246); copying the images to
        # the host waits for the card
        noise, y = noise_and_labels(config, rng, [0], device=device)
        out = sampler(noise, y)
        out.images.cpu()
        reps = 300 if args.n_sample is None else args.n_sample
        times, nfes = [], [out.nfe]
        for _ in range(reps):
            t0 = time.perf_counter()
            out = sampler(noise, y)
            out.images.cpu()
            times.append((time.perf_counter() - t0) * 1e3)
            nfes.append(out.nfe)
        print(f"Inference time: {np.mean(times):.2f}+/-{np.std(times):.2f}ms")
        return {"ms": times, "nfe": nfes}

    # the JAX CLI's image grid (lfm_tpu/cli/main.py:505-513); --out keeps
    # the raw images as .npy instead
    path = args.out or sample_grid_path(config)
    if not args.out:
        require_pil("the sample grid's JPEG")  # before sampling, not after
    noise, y = noise_and_labels(config, rng, range(sc.batch_size), device=device)
    out = sampler(noise, y)  # the whole batch on every rank
    if is_main_process():
        images = out.images.cpu().numpy()
        if args.out:
            np.save(path, images)
        else:
            save_image_grid(images, path)
        print(f"Samples are saved at {path} (NFE {out.nfe:.0f})")
    return path


def _resolve_downstream_config(args) -> Config:
    """The downstream subcommands' config (lfm_tpu/cli/main.py:187-265),
    with the network's input channels: 9 for inpainting (latent, masked
    latent, mask), 8 for semantic synthesis (latent, rescaled labels)."""
    config = _base_config(args)
    g = vars(args).get
    if args.cmd.startswith("train"):
        config = config.replace(train=_over(
            config.train, lr=g("lr"), num_epoch=g("num_epoch"), use_ema=g("use_ema"),
            save_content=g("save_content"), batch_size=args.batch_size, seed=args.seed))
    else:
        config = config.replace(sample=_over(
            config.sample, method=g("method"), num_steps=g("num_steps"),
            batch_size=args.batch_size, epoch_id=g("epoch_id"), seed=args.seed,
            n_sample=g("n_sample")))
    in_ch = 9 if args.cmd.endswith("inpainting") else 8
    return config.replace(data=_over(config.data, dataset=args.dataset, datadir=args.datadir),
                          model=dataclasses.replace(config.model, num_in_channels=in_ch))


def _rescaler(num_classes: int):
    from lfm_tpu_torch.nn.encoders import SpatialRescaler

    return SpatialRescaler(n_stages=3, multiplier=0.5, in_channels=num_classes, out_channels=4)


def _load_downstream_params(config: Config, args, rescaler, device: torch.device):
    """The bf16 network (attention through the kernels where
    ``use_flash_attention``) and the rescaler (or None) with the weights of
    ``--ckpt``: this package's downstream ``model_{E}.pth`` (``model.*``
    and ``cond.*``) sets both; a reference ``model_{E}.pth`` (the bare
    network) sets the network; without one, or where it does not exist,
    both keep the JAX package's initialisation, with a warning."""
    model = create_network(config.model, dtype=torch.bfloat16,
                           use_flash=config.model.use_flash_attention, device=device)
    unet_init_(model, 0)
    if rescaler is not None:
        rescaler.to(device).reset_parameters(seeded_generator(device, 0))
    path = args.ckpt
    if not (path and os.path.isfile(path)):
        print(f"[warn] checkpoint {path} not found; using random init", file=sys.stderr)
        return model, rescaler
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if all(k.startswith(("model.", "cond.")) for k in sd):
        if rescaler is not None:
            rescaler.load_state_dict({k[5:]: v for k, v in sd.items() if k.startswith("cond.")})
        sd = {k[6:]: v for k, v in sd.items() if k.startswith("model.")}
    model.load_state_dict(reference_state_dict(sd))
    return model, rescaler


def downstream_main(args):
    """``train-inpainting``, ``train-semantic`` (the final TrainState),
    ``test-inpainting`` and ``test-semantic`` (the directory written)
    (lfm_tpu/cli/main.py:382-466)."""
    from lfm_tpu_torch.data.segmentation import get_segmentation_dataset

    config = _resolve_downstream_config(args)
    device = resolve_device(args.device)
    sc = config.sample
    seg = None
    if args.cmd.endswith("semantic"):
        seg = get_segmentation_dataset(args.seg_dataset, config.data.datadir,
                                       size=config.model.image_size,
                                       **({"split": args.split} if args.cmd.startswith("test")
                                          else {}))
    if args.cmd == "train-inpainting":
        from lfm_tpu_torch.data import get_inpainting_dataset
        from lfm_tpu_torch.train.downstream_loops import train_inpainting

        return train_inpainting(config, get_inpainting_dataset(config),
                                _load_vae(args.vae_ckpt, device), device=device,
                                max_steps=args.max_steps)
    if args.cmd == "train-semantic":
        from lfm_tpu_torch.train.downstream_loops import train_semantic

        return train_semantic(config, seg, _load_vae(args.vae_ckpt, device),
                              _rescaler(seg.num_classes), num_classes=seg.num_classes,
                              device=device, max_steps=args.max_steps)
    if args.cmd == "test-inpainting":
        from lfm_tpu_torch.sample.downstream import InpaintingEvalDataset, run_inpainting_eval

        model, _ = _load_downstream_params(config, args, None, device)
        save_dir = os.path.join(args.save_dir, config.dataset)
        run_inpainting_eval(config, model, None, _load_vae(args.vae_ckpt, device), None,
                            InpaintingEvalDataset(args.indir, args.maskdir), save_dir,
                            batch_size=sc.batch_size, device=device)
        print(f"composited samples saved to {save_dir}; score with "
              "lfm_tpu_torch.eval.inpainting_metrics.calculate_metrics")
        return save_dir

    from lfm_tpu_torch.sample.downstream import make_semantic_sampler

    Image = require_pil("test-semantic's JPEG files")
    model, rescaler = _load_downstream_params(config, args, _rescaler(seg.num_classes), device)
    sampler = make_semantic_sampler(config, model, None, rescaler, None,
                                    _load_vae(args.vae_ckpt, device), None,
                                    num_classes=seg.num_classes, seed=sc.seed, device=device)
    os.makedirs(args.save_dir, exist_ok=True)
    n = min(args.n_sample or 8, len(seg))
    for start in range(0, n, sc.batch_size):
        idx = range(start, min(start + sc.batch_size, n))
        out = sampler(np.stack([seg[i][1] for i in idx]), idx).images.cpu().numpy()
        for j, i in enumerate(idx):
            Image.fromarray((out[j] * 255).astype(np.uint8)).save(
                os.path.join(args.save_dir, f"{i}.jpg"))
    print(f"{n} semantic samples saved to {args.save_dir}")
    return args.save_dir


def sample_grid_path(config: Config) -> str:
    """The JAX CLI's ``sample`` file name,
    ``./samples_{dataset}_{method}_{atol}_{rtol}[_cfg{scale}].jpg``, and
    with the Karras samplers ``./samples_{dataset}_{method}_{num_steps}
    [_cfg{scale}].jpg`` (lfm_tpu/cli/main.py:505-512)."""
    sc = config.sample
    if sc.use_karras_samplers:
        path = f"./samples_{config.dataset}_{sc.method}_{sc.num_steps}"
    else:
        path = f"./samples_{config.dataset}_{sc.method}_{sc.atol}_{sc.rtol}"
    if (config.model.num_classes or 0) > 1:
        path += f"_cfg{sc.cfg_scale}"
    return path + ".jpg"


if __name__ == "__main__":
    main()
