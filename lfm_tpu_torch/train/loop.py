"""The training loop on one device (port of lfm_tpu/train/loop.py).

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
``unet_init_``). The multi-device, shard_map and pipeline-parallel
branches of the JAX loop are not ported: a mesh other than one device
raises.
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
from lfm_tpu_torch.core.config import Config, MeshConfig, SampleConfig
from lfm_tpu_torch.core.device import DeviceLike, resolve_device
from lfm_tpu_torch.core.preemption import PreemptionGuard
from lfm_tpu_torch.core.rng import SampleRNG
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


def check_single_device(mesh: MeshConfig) -> None:
    if mesh.dp not in (-1, 1) or (mesh.fsdp, mesh.tp, mesh.sp, mesh.pp) != (1, 1, 1, 1):
        raise NotImplementedError(
            "multi-device training (dp, fsdp, tp, sp, pp other than 1) is not ported yet "
            f"(ROADMAP Queue 1 item 8); got {mesh}")


def train(config: Config, *, dataset=None, vae=None, device: DeviceLike = None,
          max_steps: Optional[int] = None, log_fn: Callable = print) -> TrainState:
    """Run training per ``config`` on ``device`` (the card unless
    ``device="cpu"``). ``vae``: this package's AutoencoderKL, frozen; without
    it the data are latents. ``config.train.model_ckpt``: a ``content.pth``
    resumes the run (optimizer and EMA too), a ``model_{E}.pth`` starts from
    its weights. Returns the final TrainState."""
    device = resolve_device(device)
    tc = config.train
    check_single_device(config.mesh)
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
    model.train()
    tx = make_optimizer(tc, steps_per_epoch)
    state = create_train_state(model)

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
        seed=tc.seed + 1)

    exp_path = config.exp_path
    os.makedirs(exp_path, exist_ok=True)
    with open(os.path.join(exp_path, "config.json"), "w") as f:
        f.write(config.to_json())

    init_epoch = 0
    if content is not None:
        init_epoch = ckpt.restore_content(content, model, state)
        log_fn(f"=> resumed from reference checkpoint {tc.model_ckpt} (epoch {init_epoch})")
        del content
    elif ckpt.has_content(exp_path):
        init_epoch = ckpt.restore_content(exp_path, model, state)
        log_fn(f"=> resume checkpoint (epoch {init_epoch})")

    log_steps, t_start = 0, time.time()
    with PreemptionGuard() as guard:
        for epoch in range(init_epoch, tc.num_epoch + 1):
            loader.set_epoch(epoch)
            for it, batch in enumerate(loader):
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
                if guard.preempted:
                    # the current epoch re-runs on resume
                    ckpt.save_content(exp_path, model, state, tx, epoch, config,
                                      use_ema=tc.use_ema)
                    log_fn(f"=> preemption signal: content checkpoint saved at epoch {epoch} "
                           f"(step {state.step})")
                    return state
                if max_steps is not None and state.step >= max_steps:
                    return state

            if epoch % tc.plot_every == 0 and vae is not None:
                _demo_plot(config, model, state, vae, exp_path, epoch, device)
            if tc.save_content and epoch % tc.save_content_every == 0:
                ckpt.save_content(exp_path, model, state, tx, epoch + 1, config,
                                  use_ema=tc.use_ema)
            if epoch % tc.save_ckpt_every == 0:
                ckpt.save_model(exp_path, model, state.ema if tc.use_ema else state.params, epoch)
    return state


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
