"""Epoch loops of the downstream conditional tasks (port of
lfm_tpu/train/downstream_loops.py).

The reference's downstream trainers
(downstream_tasks/train_flow_latent_inpainting.py:69-226,
train_flow_latent_semantic_syn.py:84-260) on the shared conditional step
(train/conditional.py): the same demo panels each ``plot_every`` epochs
(masked or ground truth, and generated), ``content.pth`` for resume and
``model_{E}.pth`` of the EMA weights. Both files hold the trained modules
as one (``cond_modules``: ``model.*``, and for semantic synthesis the
jointly trained SpatialRescaler as ``cond.*``, where the reference writes
a separate ``cond_stage_model_{E}.pth``). The network is
``create_network``'s, with its attention through K1 / K3 on the card where
``use_flash_attention`` is set, initialised as the JAX package initialises
it. Over several ranks each batch is split over every rank (the data
axis of ``make_mesh()``, as JAX's loop takes every local device) with the
state replicated; rank 0 alone writes the config, the panels and the
checkpoints.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from lfm_tpu_torch.core import checkpoint as ckpt
from lfm_tpu_torch.core.config import Config
from lfm_tpu_torch.core.device import DeviceLike, resolve_device
from lfm_tpu_torch.core.multihost import is_main_process
from lfm_tpu_torch.core.rng import seeded_generator
from lfm_tpu_torch.core.sharding import make_mesh, shard_batch
from lfm_tpu_torch.data.loader import DataLoader
from lfm_tpu_torch.nn.factory import create_network
from lfm_tpu_torch.nn.init import dit_init_, unet_init_
from lfm_tpu_torch.train.conditional import (cond_modules, inpainting_condition,
                                             make_cond_train_step, sample_conditional,
                                             semantic_condition)
from lfm_tpu_torch.train.loop import save_image_grid, saved_by_rank0
from lfm_tpu_torch.train.state import TrainState, create_train_state, make_optimizer

INPAINT_KEYS = ("x", "mask", "masked")
SEMANTIC_KEYS = ("x", "seg")


def _network(config: Config, device: torch.device):
    tc = config.train
    model = create_network(config.model,
                           dtype=torch.bfloat16 if tc.precision == "bf16" else torch.float32,
                           use_flash=config.model.use_flash_attention, device=device)
    is_dit = config.model.is_dit and not config.model.use_origin_adm
    (dit_init_ if is_dit else unet_init_)(model, tc.seed)
    return model.train()


def train_inpainting(config: Config, dataset, vae, *, device: DeviceLike = None,
                     log_fn: Callable = print, max_steps: Optional[int] = None) -> TrainState:
    """(train_flow_latent_inpainting.py:69-226). ``dataset`` yields (image,
    mask, masked); ``vae`` is this package's AutoencoderKL, frozen; the
    network takes ``num_in_channels`` (9). Returns the final TrainState."""
    device = resolve_device(device)
    model, vae = _network(config, device), _frozen(vae, device)
    cond_fn = inpainting_condition(vae, config.scale_factor)
    return _run_cond_loop(config, model, None, cond_fn, vae, dataset, INPAINT_KEYS, device,
                          log_fn, max_steps, task="inpaint")


def train_semantic(config: Config, dataset, vae, rescaler, *, num_classes: int,
                   device: DeviceLike = None, log_fn: Callable = print,
                   max_steps: Optional[int] = None) -> TrainState:
    """(train_flow_latent_semantic_syn.py:84-260). ``dataset`` yields
    (image, seg); the network takes ``num_in_channels`` (8); ``rescaler``
    (nn/encoders.py) trains jointly, initialised from ``seed + 1``."""
    device = resolve_device(device)
    model, vae = _network(config, device), _frozen(vae, device)
    rescaler = rescaler.to(device).train()
    rescaler.reset_parameters(seeded_generator(device, config.train.seed + 1))
    cond_fn = semantic_condition(vae, config.scale_factor, num_classes)
    return _run_cond_loop(config, model, rescaler, cond_fn, vae, dataset, SEMANTIC_KEYS, device,
                          log_fn, max_steps, task="mask2image")


def _frozen(vae, device: torch.device):
    return vae.to(device).eval().requires_grad_(False)


def _cond_batches(dataset, keys, batch_size: int, seed: int):
    """(loader, batches): ``batches()`` yields {key: stacked numpy array} of
    the dataset's item tuples, in DataLoader's per-epoch shuffled order."""

    class _Wrap:
        def __len__(self):
            return len(dataset)

        def __getitem__(self, i):
            return dict(zip(keys, dataset[i])), 0

    loader = DataLoader(_Wrap(), batch_size, shuffle=True, drop_last=True, seed=seed,
                        with_labels=False)

    def batches():
        for b in loader:
            yield {k: np.stack([it[k] for it in b["x"]]) for k in keys}

    return loader, batches


def _run_cond_loop(config: Config, model, cond, cond_fn, vae, dataset, keys,
                   device: torch.device, log_fn: Callable, max_steps: Optional[int],
                   task: str) -> TrainState:
    tc = config.train
    mesh = make_mesh()
    main_proc = is_main_process()
    if not main_proc:
        log_fn = lambda *a, **k: None  # noqa: E731
    mods = cond_modules(model, cond)
    tx = make_optimizer(tc, steps_per_epoch=max(len(dataset) // tc.batch_size, 1))
    state = create_train_state(mods)
    step = make_cond_train_step(model, cond, cond_fn, tx, ema_decay=tc.ema_decay,
                                use_ema=tc.use_ema, seed=tc.seed + 2, mesh=mesh)
    exp_path = os.path.join(config.output_dir + f"_{task}", config.dataset, config.exp)
    if main_proc:
        os.makedirs(exp_path, exist_ok=True)
        with open(os.path.join(exp_path, "config.json"), "w") as f:
            f.write(config.to_json())

    init_epoch = 0
    if ckpt.has_content(exp_path):
        init_epoch = ckpt.restore_content(exp_path, mods, state)
        log_fn(f"=> resume checkpoint (epoch {init_epoch})")

    loader, batches = _cond_batches(dataset, keys, tc.batch_size, tc.seed)
    for epoch in range(init_epoch, tc.num_epoch + 1):
        loader.set_epoch(epoch)
        for it, batch in enumerate(batches()):
            batch = shard_batch(mesh, batch)
            loss, _ = step(state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
            if it % 100 == 0:
                log_fn(f"epoch {epoch} iteration{it}, Loss: {float(loss)}")
            if max_steps is not None and state.step >= max_steps:
                return state

        if epoch % tc.plot_every == 0 and main_proc:
            _demo_panel(config, mods, state, cond_fn, vae, dataset, exp_path, epoch, task,
                        device)
        if tc.save_content and epoch % tc.save_content_every == 0:
            saved_by_rank0(ckpt.save_content, exp_path, mods, state, tx, epoch + 1, config,
                           use_ema=tc.use_ema)
        if epoch % tc.save_ckpt_every == 0:
            saved_by_rank0(ckpt.save_model, exp_path, mods,
                           state.ema if tc.use_ema else state.params, epoch)
    return state


@torch.no_grad()
def _demo_panel(config: Config, mods, state: TrainState, cond_fn, vae, dataset,
                exp_path: str, epoch: int, task: str, device: torch.device) -> None:
    """Demo panels of 4 items: a centre-box mask for inpainting
    (train:176-201), the ground truth for semantic synthesis
    (train_semantic:202-224); euler at 50 steps with the network's EMA
    weights (the condition through the live rescaler, as JAX)."""
    items = [dataset[i] for i in range(min(4, len(dataset)))]
    img = np.stack([it[0] for it in items])
    if task == "inpaint":
        h = img.shape[1]
        mask = np.zeros((len(items), h, h, 1), np.float32)
        mask[:, h // 4: 3 * h // 4, h // 4: 3 * h // 4] = 1.0
        batch = {"x": img, "mask": mask, "masked": img * (1 - mask)}
        save_image_grid(batch["masked"], os.path.join(exp_path, f"image_epoch_masked_{epoch}.png"))
    else:
        batch = {"x": img, "seg": np.stack([it[1] for it in items])}
        save_image_grid(img, os.path.join(exp_path, f"image_epoch_{epoch}_gt.png"))
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    gen = seeded_generator(device, epoch)
    model = mods["model"]
    _, c = cond_fn(mods["cond"] if "cond" in mods else None, batch, generator=gen)
    noise = torch.randn(c.shape[:3] + (4,), generator=gen, device=device)
    idx = [i for i, name in enumerate(state.names) if name.startswith("model.")]
    live = [state.params[i].detach().clone() for i in idx]
    if config.train.use_ema:
        torch._foreach_copy_([state.params[i] for i in idx], [state.ema[i] for i in idx])
    try:
        model.eval()
        z0, _ = sample_conditional(model, c, noise, method="euler", num_steps=50)
        fake = vae.decode(z0 / config.scale_factor)
    finally:
        torch._foreach_copy_([state.params[i] for i in idx], live)
        model.train()
    save_image_grid(fake.cpu().numpy(), os.path.join(exp_path, f"image_epoch_{epoch}.png"))
