"""Train state: AdamW moments and EMA weights beside the model's parameters
(port of lfm_tpu/train/state.py).

The JAX package keeps params, the optax ``adamw`` state and the EMA as
pytrees. Here the parameters are the model's own f32 master tensors,
updated in place, and the moments and EMA are lists in ``parameters()``
order. The arithmetic is optax's ``adamw`` (scale_by_adam ->
add_decayed_weights -> scale_by_learning_rate) followed by the EMA
(reference EMA.py:55-60), as ``make_fused_adamw_ema`` writes it: b1 0.9,
b2 0.999, eps 1e-8 outside the square root, decoupled decay
``p -= lr * (u + wd * p)``, with the bias corrections and the learning rate
in f32. The update runs as ``torch._foreach_*`` ops over all tensors at
once, outside any kernel, as XLA fuses it in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from lfm_tpu_torch.core.config import TrainConfig
from lfm_tpu_torch.core.partition import Partitioned


def cosine_epoch_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """CosineAnnealingLR stepped per epoch (reference train_flow_latent.py:89,
    172-173): lr(e) = eta_min + (lr - eta_min) (1 + cos(pi e / E)) / 2, with
    e = step // steps_per_epoch clamped to E; f32 as in the JAX package."""

    def schedule(step: int) -> float:
        if cfg.no_lr_decay:
            return float(np.float32(cfg.lr))
        epoch = min(int(step) // max(steps_per_epoch, 1), cfg.num_epoch)
        frac = np.float32(epoch) / np.float32(cfg.num_epoch)
        cos = np.cos(np.float32(np.pi) * frac, dtype=np.float32)
        return float(np.float32(cfg.lr_min)
                     + np.float32(0.5 * (cfg.lr - cfg.lr_min)) * (np.float32(1.0) + cos))

    return schedule


def decay_mask(names: List[str]) -> List[bool]:
    """False where decoupled weight decay is skipped: the frozen random
    Fourier features ``W`` (lfm_tpu/train/state.py::_decays)."""
    return [name.rsplit(".", 1)[-1] != "W" for name in names]


@dataclass(frozen=True)
class AdamW:
    """optax.adamw's hyper-parameters: ``lr`` is the schedule of the step."""

    lr: Callable[[int], float]
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int) -> AdamW:
    """AdamW with the reference's betas and decay (train_flow_latent.py:84,
    320-321: betas (0.9, 0.999); argparse beta1/beta2 never reach AdamW)."""
    return AdamW(lr=cosine_epoch_schedule(cfg, steps_per_epoch),
                 weight_decay=cfg.weight_decay)


@dataclass
class TrainState:
    """``step``: global steps taken (the schedule's count); ``count``: Adam's
    bias-correction count (optax ScaleByAdamState.count). ``params`` are
    the model's parameters, updated in place; ``ema`` equals them when EMA
    is off. With ``layout`` (core/partition.py) ``params`` are its masters,
    the rank's slices where a parameter is split, and the moments and EMA
    are split alike."""

    names: List[str]
    params: List[torch.Tensor]
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    ema: List[torch.Tensor]
    step: int = 0
    count: int = 0
    layout: Optional[Partitioned] = None
    # without a layout: the group each parameter is split over for the
    # gradient norm (a pipeline stage's blocks over pipe), None replicated
    norm_groups: Optional[List] = None

    @property
    def module_params(self) -> List[torch.Tensor]:
        """The parameters the forward runs on, whose ``.grad`` backward fills."""
        return self.params if self.layout is None else self.layout.params


def create_train_state(model: nn.Module, layout: Optional[Partitioned] = None) -> TrainState:
    names, params = zip(*model.named_parameters())
    if layout is not None:
        params = layout.masters
    with torch.no_grad():
        return TrainState(names=list(names), params=list(params),
                          mu=[torch.zeros_like(p) for p in params],
                          nu=[torch.zeros_like(p) for p in params],
                          ema=[p.detach().clone() for p in params], layout=layout)


def global_grad_norm(grads: List[torch.Tensor],
                     groups: Optional[List] = None) -> torch.Tensor:
    """The norm of the whole gradient. ``groups[i]`` is the process group
    that grads[i]'s elements are split over (None: every rank holds it
    whole): the split ones' squares are summed over their group, once a
    group, and a whole one is counted once, not once a rank."""
    norms = torch._foreach_norm(grads)
    if groups is None or all(g is None for g in groups):
        return torch.linalg.vector_norm(torch.stack(norms))
    by_group = {}
    for n, g in zip(norms, groups):
        by_group.setdefault(g, []).append(n)
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g, ns in by_group.items():
        sq = torch.sum(torch.square(torch.stack(ns)))
        if g is not None:
            dist.all_reduce(sq, group=g)
        total = total + sq
    return torch.sqrt(total)


def make_fused_adamw_ema(tx: AdamW, *, ema_decay: float = 0.9999,
                         use_ema: bool = True) -> Callable[[TrainState, List[torch.Tensor]],
                                                           torch.Tensor]:
    """``update(state, grads) -> grad_norm``: one AdamW + EMA step over
    every tensor, in place, and the global norm of the f32 gradients
    (lfm_tpu/train/state.py::make_fused_adamw_ema)."""

    def update(state: TrainState, grads: List[torch.Tensor]) -> torch.Tensor:
        count = state.count + 1
        lr = np.float32(tx.lr(state.step))
        c1 = float(np.float32(1.0) - np.float32(tx.b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(tx.b2) ** np.float32(count))
        p, m, v, e = state.params, state.mu, state.nu, state.ema
        with torch.no_grad():
            g = [t.float() for t in grads]
            gnorm = global_grad_norm(g, state.norm_groups if state.layout is None
                                     else state.layout.groups)
            # m = b1 m + (1 - b1) g ; v = b2 v + (1 - b2) g^2
            torch._foreach_mul_(m, tx.b1)
            torch._foreach_add_(m, g, alpha=1.0 - tx.b1)
            torch._foreach_mul_(v, tx.b2)
            torch._foreach_addcmul_(v, g, g, value=1.0 - tx.b2)
            # u = (m / c1) / (sqrt(v / c2) + eps) [+ wd p]
            u = torch._foreach_div(m, c1)
            den = torch._foreach_sqrt(torch._foreach_div(v, c2))
            torch._foreach_add_(den, tx.eps)
            torch._foreach_div_(u, den)
            if tx.weight_decay:
                idx = [i for i, d in enumerate(decay_mask(state.names)) if d]
                torch._foreach_add_([u[i] for i in idx],
                                    torch._foreach_mul([p[i] for i in idx], tx.weight_decay))
            # p = p - lr u ; ema = decay ema + (1 - decay) p
            torch._foreach_add_(p, u, alpha=-float(lr))
            if use_ema:
                torch._foreach_mul_(e, ema_decay)
                torch._foreach_add_(e, p, alpha=1.0 - ema_decay)
            else:
                torch._foreach_copy_(e, p)
        state.count = count
        state.step += 1
        return gnorm

    return update

