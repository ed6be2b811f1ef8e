"""Flow-matching train step on one device (port of lfm_tpu/train/train.py).

One step (reference train_flow_latent.py:135-170): encode the images with
the frozen VAE (unless the data are latents) and scale by ``scale_factor``;
draw t ~ U(0, 1) and z1 ~ N(0, 1); the interpolant and its target
velocity; the DiT forward in train mode (label dropout); the MSE loss;
backward; AdamW + EMA + the gradient norm (train/state.py). Every draw
comes from one ``torch.Generator`` on the device, seeded from the seed and
the step number, in this order: the encoder's eps, t, z1, the label-dropout
mask. JAX's threefry bits cannot be matched, so the parity tests hand both
packages the same draws (``fm_train_loss``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from lfm_tpu_torch.core.rng import seeded_generator
from lfm_tpu_torch.ode.flow import interpolate
from lfm_tpu_torch.train.state import AdamW, TrainState, make_fused_adamw_ema


def fm_train_loss(model: nn.Module, z0: torch.Tensor, y: Optional[torch.Tensor],
                  t: torch.Tensor, z1: torch.Tensor, *,
                  generator: Optional[torch.Generator] = None,
                  force_drop_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean((v(t, z_t, y) - u)^2) in f32, the model in train mode
    (train.py::loss_fn with t and z1 given)."""
    z_t, u = interpolate(z0, z1, t)
    v = model(t, z_t, y, train=True, generator=generator, force_drop_ids=force_drop_ids)
    return torch.mean(torch.square(v.float() - u.float()))


def make_train_step(model: nn.Module, tx: AdamW, *, ema_decay: float = 0.9999,
                    use_ema: bool = True,
                    encode_fn: Optional[Callable[[torch.Tensor, torch.Generator],
                                                 torch.Tensor]] = None,
                    scale_factor: float = 0.18215, is_latent_data: bool = False,
                    label_dropout: bool = False, seed: int = 0
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[torch.Tensor, torch.Tensor]]:
    """``train_step(state, batch) -> (loss, grad_norm)``, updating the model
    and ``state`` in place. ``batch``: {"x": NHWC images in [-1, 1] (or
    latents) on the model's device, "y": labels or absent}. ``encode_fn(x,
    generator)`` returns unscaled latents (``AutoencoderKL.encode_sample``);
    it runs without gradients. Label dropout draws from the step's
    generator when ``label_dropout``."""
    update = make_fused_adamw_ema(tx, ema_decay=ema_decay, use_ema=use_ema)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        x = batch["x"]
        y = batch.get("y")
        gen = seeded_generator(x.device, seed, state.step)
        if is_latent_data or encode_fn is None:
            z0 = x * scale_factor if is_latent_data else x
        else:
            with torch.no_grad():
                z0 = encode_fn(x, gen) * scale_factor
        z0 = z0.float()
        t = torch.rand((z0.shape[0],), generator=gen, device=z0.device)
        z1 = torch.randn(z0.shape, generator=gen, device=z0.device)
        for p in state.params:
            p.grad = None
        loss = fm_train_loss(model, z0, y, t, z1, generator=gen if label_dropout else None)
        loss.backward()
        gnorm = update(state, [torch.zeros_like(p) if p.grad is None else p.grad
                               for p in state.params])
        return loss.detach(), gnorm

    return train_step
