"""Conditional flow matching: the machinery both downstream tasks share
(port of lfm_tpu/train/conditional.py).

The reference's two downstream trainers
(downstream_tasks/train_flow_latent_inpainting.py:141-160,
train_flow_latent_semantic_syn.py:174-196) concatenate a condition map
``c`` at latent resolution with the interpolant before the velocity net: 9
input channels for inpainting (4 latent + 4 masked latent + 1 mask), 8 for
semantic synthesis (4 + 4 from the SpatialRescaler); at sampling time it
goes with the ODE state (``WrapperCondFlow``, inpainting.py:45-53).

A condition function ``cond_fn(cond, batch, generator=None, eps=None) ->
(z_data, c)`` encodes the batch with the frozen VAE (no gradient) and
builds ``c``, through ``cond`` (the rescaler, trained jointly; None for
inpainting) with gradient. Each VAE posterior draw takes its eps from
``eps`` (one tensor per encode, in order) or else from ``generator``. The
train step draws from one generator on the device, seeded from the seed
and the step: the posterior eps (the image's, then the masked image's),
then t, then the noise. JAX's threefry bits cannot be matched, so the
parity tests hand both packages the same draws (``cond_fm_loss``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lfm_tpu_torch.core.device import no_tf32
from lfm_tpu_torch.core.rng import draw_rows, seeded_generator
from lfm_tpu_torch.core.sharding import DATA_AXIS, Mesh, all_reduce_mean_, global_rows
from lfm_tpu_torch.ode.flow import interpolate
from lfm_tpu_torch.ode.solvers import odeint
from lfm_tpu_torch.train.state import AdamW, TrainState, make_fused_adamw_ema

Batch = Dict[str, torch.Tensor]
CondFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def cond_modules(model: nn.Module, cond: Optional[nn.Module]) -> nn.ModuleDict:
    """The trained modules as one: ``model.*`` then ``cond.*`` in
    ``parameters()`` order, JAX's params {"model": ..., "cond": ...}."""
    mods = nn.ModuleDict({"model": model})
    if cond is not None:
        mods["cond"] = cond
    return mods


def cond_fm_loss(model: nn.Module, cond_fn: CondFn, cond: Optional[nn.Module], batch: Batch,
                 t: torch.Tensor, z1: torch.Tensor, *,
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """mean((v(t, [z_t ++ c]) - u)^2) in f32 (make_cond_train_step's
    loss_fn with t, the noise z1 and the posterior eps given)."""
    z0, c = cond_fn(cond, batch, generator=generator, eps=eps)
    return _loss(model, z0, c, t, z1)


def _loss(model: nn.Module, z0, c, t, z1) -> torch.Tensor:
    z_t, u = interpolate(z0, z1, t)
    v = model(t, torch.cat([z_t, c.to(z_t.dtype)], dim=-1))
    return torch.mean(torch.square(v.float() - u.float()))


def make_cond_train_step(model: nn.Module, cond: Optional[nn.Module], cond_fn: CondFn,
                         tx: AdamW, *, ema_decay: float = 0.9999, use_ema: bool = True,
                         seed: int = 0, mesh: Optional[Mesh] = None
                         ) -> Callable[[TrainState, Batch], Tuple[torch.Tensor, torch.Tensor]]:
    """``train_step(state, batch) -> (loss, grad_norm)`` over
    ``create_train_state(cond_modules(model, cond))``, updating the modules
    and ``state`` in place (AdamW + EMA + the global gradient norm over
    both, as train/train.py). ``mesh``: ``batch`` holds this rank's rows;
    the draws, gradients and loss are the global batch's, as in
    train/train.py."""
    update = make_fused_adamw_ema(tx, ema_decay=ema_decay, use_ema=use_ema)
    data_group = None if mesh is None else mesh.group(DATA_AXIS)

    def train_step(state: TrainState, batch: Batch):
        x = batch["x"]
        gen = seeded_generator(x.device, seed, state.step, rows=global_rows(mesh, x.shape[0]))
        for p in state.params:
            p.grad = None
        z0, c = cond_fn(cond, batch, generator=gen)
        t = draw_rows(torch.rand, (z0.shape[0],), gen, z0.device)
        z1 = draw_rows(torch.randn, z0.shape, gen, z0.device)
        loss = _loss(model, z0, c, t, z1)
        with no_tf32():  # the UNet's f32 convolutions' backward in f32, as their forward
            loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in state.params]
        loss = loss.detach()
        if data_group is not None:
            all_reduce_mean_(grads + [loss.reshape(1)], data_group)
        gnorm = update(state, grads)
        return loss, gnorm

    return train_step


def cond_velocity(model: nn.Module, c: torch.Tensor) -> Callable:
    """WrapperCondFlow: v(t, x) = model(t, [x ++ c])."""

    def v(t, x):
        t_b = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(
            x.shape[0])
        return model(t_b, torch.cat([x, c.to(x.dtype)], dim=-1))

    return v


@torch.no_grad()
def sample_conditional(model: nn.Module, c: torch.Tensor, noise: torch.Tensor, *,
                       method: str = "dopri5", atol: float = 1e-8, rtol: float = 1e-8,
                       num_steps: int = 40) -> Tuple[torch.Tensor, float]:
    """The conditional ODE from t = 1 to 0; returns (z_0, nfe). The
    reference's downstream demo uses atol = rtol = 1e-8
    (train_flow_latent_inpainting.py:61-65)."""
    res = odeint(cond_velocity(model, c), noise.float(), 1.0, 0.0, method=method, atol=atol,
                 rtol=rtol, num_steps=num_steps)
    return res.y, res.nfe


def _encode(vae, x: torch.Tensor, generator, eps, i: int) -> torch.Tensor:
    with torch.no_grad():
        return vae.encode_sample(x, generator, None if eps is None else eps[i])


def mask_to_latent(mask: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(N, H, W, 1) mask -> (N, h, w, 1): ``jax.image.resize(...,
    "nearest")``, which picks the pixel under each output pixel's centre,
    as torch's ``nearest-exact`` does (not ``nearest``)."""
    m = F.interpolate(mask.float().permute(0, 3, 1, 2), size=size, mode="nearest-exact")
    return m.permute(0, 2, 3, 1)


def inpainting_condition(vae, scale_factor: float) -> CondFn:
    """cond_fn for inpainting (train_flow_latent_inpainting.py:148-152):
    c = VAE(masked) * scale ++ the mask at latent resolution. batch: x (the
    image), mask (N, H, W, 1), masked (image * (1 - mask))."""

    def fn(_cond, batch: Batch, generator=None, eps=None):
        z = _encode(vae, batch["x"], generator, eps, 0) * scale_factor
        cz = _encode(vae, batch["masked"], generator, eps, 1) * scale_factor
        return z, torch.cat([cz, mask_to_latent(batch["mask"], cz.shape[1:3])], dim=-1)

    return fn


def semantic_condition(vae, scale_factor: float, num_classes: int) -> CondFn:
    """cond_fn for semantic synthesis (train_flow_latent_semantic_syn.py:
    174-191): c = SpatialRescaler(one_hot(seg)), with gradient to the
    rescaler. batch: x (the image), seg (N, H, W) integer labels."""

    def fn(rescaler, batch: Batch, generator=None, eps=None):
        z = _encode(vae, batch["x"], generator, eps, 0) * scale_factor
        onehot = F.one_hot(batch["seg"].long(), num_classes).float()
        return z, rescaler(onehot)

    return fn
