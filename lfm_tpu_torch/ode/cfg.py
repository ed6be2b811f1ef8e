"""Classifier-free guidance wrappers (port of lfm_tpu/ode/cfg.py).

The state stays at N samples; cond and uncond are evaluated as one 2N
forward (reference models/DiT.py:274-290, test_flow_latent.py:172-181).
Channels are the last axis (NHWC).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _broadcast_t(t, n: int, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=device).reshape(-1).expand(n)


def cfg_velocity(model_fn: Callable, y: torch.Tensor, y_null: torch.Tensor,
                 cfg_scale: float, guide_channels: Optional[int] = None) -> Callable:
    """v(t, x) that evaluates cond + uncond in one doubled forward.
    ``guide_channels`` limits guidance to the first K channels."""

    def v(t, x):
        n = x.shape[0]
        x2 = torch.cat([x, x], dim=0)
        y2 = torch.cat([y, y_null], dim=0)
        out = model_fn(_broadcast_t(t, 2 * n, x.device), x2, y2)
        cond, uncond = out[:n], out[n:]
        if guide_channels is None:
            return uncond + cfg_scale * (cond - uncond)
        eps_c, rest = cond[..., :guide_channels], cond[..., guide_channels:]
        eps_u = uncond[..., :guide_channels]
        eps = eps_u + cfg_scale * (eps_c - eps_u)
        return torch.cat([eps, rest], dim=-1)

    return v


def plain_velocity(model_fn: Callable, y: Optional[torch.Tensor] = None) -> Callable:
    """v(t, x) with scalar t broadcast to the batch (models/DiT.py:64-66)."""

    def v(t, x):
        return model_fn(_broadcast_t(t, x.shape[0], x.device), x, y)

    return v
