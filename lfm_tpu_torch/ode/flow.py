"""Linear flow-matching objective (port of lfm_tpu/ode/flow.py).

Interpolant ``z_t = (1 - t) z_0 + (1e-5 + (1 - 1e-5) t) z_1`` with velocity
target ``u = (1 - 1e-5) z_1 - z_0``; z_0 is the data latent, z_1 the noise
(reference train_flow_latent.py:144-153). Sampling integrates dz/dt = v(t, z)
from t=1 down to t=0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SIGMA_MIN = 1e-5


def interpolate(z0: torch.Tensor, z1: torch.Tensor,
                t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (z_t, u) for batched t of shape (B,)."""
    t = t.reshape((-1,) + (1,) * (z0.dim() - 1)).to(z0.dtype)
    z_t = (1.0 - t) * z0 + (SIGMA_MIN + (1.0 - SIGMA_MIN) * t) * z1
    u = (1.0 - SIGMA_MIN) * z1 - z0
    return z_t, u


def fm_loss(velocity_fn, z0: torch.Tensor, generator: torch.Generator,
            y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Monte-Carlo flow-matching MSE: t ~ U(0,1), noise ~ N(0,1), drawn
    from ``generator`` (which must live on z0's device)."""
    t = torch.rand((z0.shape[0],), generator=generator, device=z0.device,
                   dtype=torch.float32)
    z1 = torch.randn(z0.shape, generator=generator, device=z0.device,
                     dtype=z0.dtype)
    z_t, u = interpolate(z0, z1, t)
    v = velocity_fn(t, z_t, y)
    return torch.mean(torch.square(v.float() - u.float()))
