"""Seeded random weights with every tensor non-zero.

The repository holds no trained checkpoint. adaLN-Zero's zero init makes
every DiT block an identity, so a wrong attention or MLP would still pass a
check; these weights give every tensor signal instead: weights
N(0, 1/fan_in), biases and embedding tables N(0, 0.02^2), norm scales
1 + N(0, 0.02^2). The draws come from a generator on the module's device,
so the same seed gives other numbers on the CPU than on the card.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """Overwrite every parameter of ``module`` in place; returns it."""
    params = sorted(module.named_parameters(), key=lambda kv: kv[0])
    if not params:
        return module
    gen = torch.Generator(device=params[0][1].device)
    gen.manual_seed(int(seed))
    norm_types = (nn.GroupNorm, nn.LayerNorm)
    norm_names = {f"{name}.weight" for name, m in module.named_modules()
                  if isinstance(m, norm_types)}
    for name, p in params:
        noise = torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32)
        if name in norm_names:
            value = 1.0 + 0.02 * noise
        elif p.dim() >= 2 and not name.endswith("embedding_table.weight"):
            value = noise / math.sqrt(p[0].numel())
        else:
            value = 0.02 * noise
        p.copy_(value.to(p.dtype))
    return module
