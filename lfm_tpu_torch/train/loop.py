"""The training loop (port of lfm_tpu/train/loop.py).

Per epoch: the shuffled batches through the train step (VAE encode + FM
loss + backward + AdamW + EMA, train/train.py), the loss and steps/s
logged every 100 iterations, a 4-sample dopri5 demo grid every
``plot_every`` epochs, ``content.pth`` every ``save_content_every`` epochs
and ``model_{E}.pth`` (EMA weights) every ``save_ckpt_every`` epochs
(reference train_flow_latent.py:48-216). A ``content.pth`` in the
experiment directory resumes the run; SIGTERM saves one at the current
epoch and returns. Every network of ``create_network`` trains: the DiT,
the origin ADM (its attention an f32 island through K1 and K3 on the card)
and EDM's DhariwalUNet, built in the ``precision`` policy's dtype and
initialised as the JAX package initialises it (``dit_init_``,
``unet_init_``).

Over several ranks (one process per GPU, core/multihost.py) the mesh of
``config.mesh`` (dp, fsdp, tp) splits each batch over its data axis, and
the state is replicated on every rank, as JAX's loop places it whatever
``--fsdp/--tp`` say (lfm_tpu/train/loop.py:168): ranks that share a data
index compute the same rows. Every rank loads the same full batch and
keeps its rows. Rank 0 alone logs, plots and writes ``config.json`` and
the checkpoints; the others wait at a barrier after each save, so the
files are those of one device. With one process SIGTERM is acted on at
once; with several the flag is all-reduced every ``preempt_check_every``
steps and every rank saves at the same step.

``config.mesh.pp`` > 1 trains pipeline-parallel (JAX's loop.py:112-160):
the DiT's blocks in stages over the pipe axis (sample/pp.py, interleaved
when ``pp_chunks`` > 1), each rank holding its stage's blocks and their
moments and EMA, the embedders and final layer replicated with their
whole gradient on every rank (core/pipeline.py), the gradient norm's block
squares summed over pipe. Checkpoints stay canonical: the stages' tensors
are gathered and rank 0 writes them in ``blocks.{i}`` order, so one
process loads them; a resume cuts them back to each stage. As in JAX,
label dropout under pp raises, and so does a pipe that spans more than
one machine (JAX's "single-process": a JAX process is a machine here).
``config.mesh.sp`` only lays out the mesh, as in JAX.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from lfm_tpu_torch.core import checkpoint as ckpt
from lfm_tpu_torch.core.config import Config, SampleConfig
from lfm_tpu_torch.core.device import DeviceLike, resolve_device
from lfm_tpu_torch.core.multihost import (any_process_flag, is_main_process, process_count,
                                          sync_hosts)
from lfm_tpu_torch.core.preemption import PreemptionGuard
from lfm_tpu_torch.core.rng import SampleRNG
from lfm_tpu_torch.core.sharding import make_mesh, shard_batch
from lfm_tpu_torch.data import DataLoader, get_dataset
from lfm_tpu_torch.data.transforms import require_pil
from lfm_tpu_torch.nn.factory import create_network
from lfm_tpu_torch.nn.init import dit_init_, unet_init_
from lfm_tpu_torch.train.state import TrainState, create_train_state, make_optimizer
from lfm_tpu_torch.train.train import make_train_step


def _write_png(path: str, img: np.ndarray) -> None:
    """(H, W, 3) or (H, W) uint8 -> an 8-bit PNG file."""
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def image_grid(images: np.ndarray, nrow: int = 8) -> np.ndarray:
    """[-1, 1] or [0, 1] NHWC batch -> one uint8 grid image, ``nrow`` images
    a row (torchvision save_image, train_flow_latent.py:185-190)."""
    imgs = np.asarray(images, np.float32)
    if imgs.min() < -0.01:  # normalise from [-1, 1]
        imgs = (imgs + 1.0) / 2.0
    imgs = np.clip(imgs, 0, 1)
    n, h, w, c = imgs.shape
    rows = -(-n // nrow)
    grid = np.zeros((rows * h, min(n, nrow) * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = imgs[i]
    return (grid * 255).astype(np.uint8).squeeze()


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8) -> None:
    """``image_grid`` written to ``path``: a ``.png`` by this module's own
    encoder, any other name through Pillow by its extension, as the JAX
    package's ``save_image_grid`` writes every name (a ``.jpg`` is JPEG)."""
    grid = image_grid(images, nrow)
    if path.endswith(".png"):
        _write_png(path, grid)
    else:
        require_pil(f"writing {path}").fromarray(grid).save(path)


def saved_by_rank0(save: Callable, *args, **kwargs) -> None:
    """``save(*args)`` on rank 0, then a barrier: a collective save whose
    file is written once."""
    if is_main_process():
        save(*args, **kwargs)
    if process_count() > 1:
        sync_hosts()


class _Named:
    """What core/checkpoint.py reads of a model: a DiT's ``pos_embed`` and
    its named parameters (here the pipeline's canonical ones)."""

    def __init__(self, pos_embed: torch.Tensor, named):
        self.pos_embed, self._named = pos_embed, named

    def named_parameters(self):
        return iter(self._named.items())


def _one_machine() -> bool:
    """Whether every rank of the job runs on this host."""
    if process_count() == 1:
        return True
    import socket

    import torch.distributed as dist

    hosts = [None] * process_count()
    dist.all_gather_object(hosts, socket.gethostname())
    return len(set(hosts)) == 1


def pp_canonical(model, state: TrainState, mesh):
    """A placed model's state gathered from the pipe stages (a collective):
    (a model view and a TrainState with the whole model's canonical names,
    in its parameter order), on every rank."""
    from lfm_tpu_torch.sample.pp import gather_canonical

    lists = [gather_canonical(model, mesh, state.names, v)
             for v in (state.params, state.mu, state.nu, state.ema)]
    params = lists[0]
    canon = TrainState(names=list(params), params=list(params.values()),
                       mu=list(lists[1].values()), nu=list(lists[2].values()),
                       ema=list(lists[3].values()), step=state.step, count=state.count)
    return _Named(model.pos_embed, params), canon


def train(config: Config, *, dataset=None, vae=None, device: DeviceLike = None,
          max_steps: Optional[int] = None, log_fn: Callable = print) -> TrainState:
    """Run training per ``config`` on ``device`` (the card unless
    ``device="cpu"``; under several ranks this rank's card). ``vae``: this
    package's AutoencoderKL, frozen; without it the data are latents.
    ``config.train.model_ckpt``: a ``content.pth`` resumes the run
    (optimizer and EMA too), a ``model_{E}.pth`` starts from its weights.
    Returns the final TrainState (the same on every rank; under pp the
    canonical one, gathered from the stages)."""
    device = resolve_device(device)
    tc = config.train
    m = config.mesh
    pp = m.pp
    pp_chunks = m.pp_chunks if pp > 1 else 1
    mesh = make_mesh(m.dp, m.fsdp, m.tp, m.sp, pp)
    if pp > 1 and not _one_machine():
        raise NotImplementedError(
            "pipeline-parallel training is single-machine (pipe-sharded state cannot be "
            "checkpointed from one rank); span machines with dp/fsdp/tp instead")
    main_proc = is_main_process()
    if not main_proc:
        log_fn = lambda *a, **k: None  # noqa: E731
    dataset = dataset if dataset is not None else get_dataset(config, seed=tc.seed)
    loader = DataLoader(dataset, tc.batch_size, shuffle=True, drop_last=True, seed=tc.seed)
    steps_per_epoch = tc.steps_per_epoch or max(len(loader), 1)

    use_label = "imagenet" in config.dataset  # train_flow_latent.py:131
    is_latent = "latent" in config.dataset    # train_flow_latent.py:132
    dtype = torch.bfloat16 if tc.precision == "bf16" else torch.float32
    model = create_network(config.model, dtype=dtype,
                           use_flash=config.model.use_flash_attention,
                           remat=tc.use_grad_checkpointing, remat_policy=tc.remat_policy,
                           device=device)
    is_dit = config.model.is_dit and not config.model.use_origin_adm
    (dit_init_ if is_dit else unet_init_)(model, tc.seed)
    content = None
    if tc.model_ckpt and os.path.exists(tc.model_ckpt):
        loaded = torch.load(tc.model_ckpt, map_location="cpu", weights_only=False)
        if "model_dict" in loaded:
            content = loaded
        else:
            model.load_state_dict(ckpt.reference_state_dict(loaded))
            log_fn(f"=> initialised from {tc.model_ckpt}")
        del loaded
    model_apply = None
    if pp > 1:
        from lfm_tpu_torch.sample.pp import (make_pp_apply, pipe_norm_groups,
                                             place_stage_blocks_, stage_content)

        if config.model.label_dropout > 0:
            raise NotImplementedError(
                "pipeline-parallel training requires label_dropout == 0 (per-stage dropout "
                "rng is not plumbed); train CFG-dropout recipes with dp/fsdp/tp instead")
        place_stage_blocks_(model, mesh, pp_chunks)
        model_apply = make_pp_apply(model, mesh, train=True, num_chunks=pp_chunks)
    model.train()
    tx = make_optimizer(tc, steps_per_epoch)
    state = create_train_state(model)
    if pp > 1:
        state.norm_groups = pipe_norm_groups(state.names, mesh)

    def canonical():
        """(model, state) as the checkpoints hold them: under pp gathered
        from the stages, a collective every rank calls."""
        return pp_canonical(model, state, mesh) if pp > 1 else (model, state)

    def restore(content):
        if pp > 1:
            content = stage_content(ckpt.load_content(content) if isinstance(content, str)
                                    else content, model)
        return ckpt.restore_content(content, model, state)

    if vae is not None:
        vae.to(device).eval().requires_grad_(False)
        encode_fn = vae.encode_sample
    else:
        encode_fn = None
        is_latent = True  # raw input is latents (synthetic / latent data)
    step_fn = make_train_step(
        model, tx, ema_decay=tc.ema_decay, use_ema=tc.use_ema, encode_fn=encode_fn,
        scale_factor=config.scale_factor, is_latent_data=is_latent,
        label_dropout=config.model.label_dropout > 0, dropout=config.model.dropout > 0,
        seed=tc.seed + 1, mesh=mesh, model_apply=model_apply)

    exp_path = config.exp_path
    if main_proc:
        os.makedirs(exp_path, exist_ok=True)
        with open(os.path.join(exp_path, "config.json"), "w") as f:
            f.write(config.to_json())

    init_epoch = 0
    if content is not None:
        init_epoch = restore(content)
        log_fn(f"=> resumed from reference checkpoint {tc.model_ckpt} (epoch {init_epoch})")
        del content
    elif ckpt.has_content(exp_path):
        init_epoch = restore(exp_path)
        log_fn(f"=> resume checkpoint (epoch {init_epoch})")

    log_steps, t_start = 0, time.time()
    n_proc = process_count()
    # a step cadence from the config, the same on every rank, so that the
    # collective check runs at the same step everywhere
    preempt_check_every = max(1, int(tc.preempt_check_every))
    with PreemptionGuard() as guard:
        for epoch in range(init_epoch, tc.num_epoch + 1):
            loader.set_epoch(epoch)
            for it, batch in enumerate(loader):
                batch = shard_batch(mesh, batch)
                b = {"x": torch.from_numpy(batch["x"]).to(device)}
                if use_label:
                    b["y"] = torch.from_numpy(batch["y"]).to(device)
                loss, _ = step_fn(state, b)
                log_steps += 1
                if it % 100 == 0:
                    dt = time.time() - t_start
                    sps = log_steps / dt if dt > 0 else 0.0
                    log_fn(f"epoch {epoch} iteration{it}, Loss: {float(loss)}, "
                           f"Train Steps/Sec: {sps:.2f}")
                    log_steps, t_start = 0, time.time()
                if n_proc == 1:
                    preempt = guard.preempted
                else:
                    preempt = (state.step % preempt_check_every == 0
                               and any_process_flag(guard.preempted))
                if preempt:
                    # the current epoch re-runs on resume
                    saved_by_rank0(ckpt.save_content, exp_path, *canonical(), tx, epoch,
                                   config, use_ema=tc.use_ema)
                    log_fn(f"=> preemption signal: content checkpoint saved at epoch {epoch} "
                           f"(step {state.step})")
                    return canonical()[1]
                if max_steps is not None and state.step >= max_steps:
                    return canonical()[1]

            if epoch % tc.plot_every == 0 and vae is not None:
                if pp > 1:
                    _pp_demo_plot(config, *canonical(), vae, exp_path, epoch, device)
                elif main_proc:
                    _demo_plot(config, model, state, vae, exp_path, epoch, device)
            if tc.save_content and epoch % tc.save_content_every == 0:
                saved_by_rank0(ckpt.save_content, exp_path, *canonical(), tx, epoch + 1,
                               config, use_ema=tc.use_ema)
            if epoch % tc.save_ckpt_every == 0:
                view, canon = canonical()
                saved_by_rank0(ckpt.save_model, exp_path, view,
                               canon.ema if tc.use_ema else canon.params, epoch)
    return canonical()[1]


def _pp_demo_plot(config: Config, view: _Named, canon: TrainState, vae, exp_path: str,
                  epoch: int, device: torch.device) -> None:
    """The demo grid of a pipeline-parallel run: rank 0 draws it from the
    canonical weights on a whole model, as JAX's loop plots from its
    canonical state on one process."""
    if not is_main_process():
        return
    weights = canon.ema if config.train.use_ema else canon.params
    dtype = torch.bfloat16 if config.train.precision == "bf16" else torch.float32
    full = create_network(config.model, dtype=dtype,
                          use_flash=config.model.use_flash_attention, device=device)
    full.load_state_dict(dict(zip(canon.names, weights)))
    _demo_plot(config, full, create_train_state(full), vae, exp_path, epoch, device)


def _demo_plot(config: Config, model, state: TrainState, vae, exp_path: str, epoch: int,
               device: torch.device) -> None:
    """4-sample dopri5 demo grid of the EMA weights (train_flow_latent.py:
    176-191), swapped into the model for the draw and back after it."""
    from lfm_tpu_torch.sample.sample import make_sampler

    demo_cfg = config.replace(sample=SampleConfig(method="dopri5"))
    weights = state.ema if config.train.use_ema else state.params
    with torch.no_grad():
        live = [p.detach().clone() for p in state.params]
        torch._foreach_copy_(state.params, weights)
    try:
        sampler = make_sampler(demo_cfg, model, None, vae, None, device=device)
        rng = SampleRNG(seed=config.train.seed)
        s, c = config.model.latent_size, config.model.num_in_channels
        noise = rng.randn(range(4), (s, s, c), device=device)
        y = None
        if (config.model.num_classes or 0) > 1:
            y = rng.randint(range(4), 0, config.model.num_classes, device=device)
        out = sampler(noise, y)
        save_image_grid(out.images.cpu().numpy(),
                        os.path.join(exp_path, f"image_epoch_{epoch}.png"))
    finally:
        with torch.no_grad():
            torch._foreach_copy_(state.params, live)
        model.train()
