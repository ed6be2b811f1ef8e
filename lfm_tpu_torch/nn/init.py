"""Weight initialisation: the DiT's training init, and seeded random weights
with every tensor non-zero.

``dit_init_`` gives a fresh DiT the JAX package's initializers (those of the
reference DiT, models/DiT.py:197-229), with other draws. The repository
holds no trained checkpoint, so the checks use ``seeded_init_``, for the
DiT and the ADM UNet alike: adaLN-Zero's zero init makes every DiT block an
identity, and the ADM's zero-initialised ``out_layers.3``, ``out.2`` and
attention ``proj_out`` hide their block, so a wrong attention, MLP or
GroupNorm would still pass a check; these weights give every tensor
signal instead: weights N(0, 1/fan_in) (fan_in = in channels x kernel
size for a convolution), biases and embedding tables N(0, 0.02^2), norm
scales 1 + N(0, 0.02^2). The draws come from a generator
on the module's device, so the same seed gives other numbers on the CPU
than on the card.
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
        elif p.dim() >= 2 and not name.endswith(("embedding_table.weight", "label_emb.weight")):
            value = noise / math.sqrt(p[0].numel())
        else:
            value = 0.02 * noise
        p.copy_(value.to(p.dtype))
    return module


@torch.no_grad()
def dit_init_(model: nn.Module, seed: int) -> nn.Module:
    """The initializers of lfm_tpu/nn/{layers,dit}.py: Xavier-uniform
    attention, MLP and patch-embedding weights (the patch conv as its
    (D, C*p*p) matrix), N(0, 0.02^2) timestep-MLP weights and label table,
    zero biases, and the adaLN-Zero modulations and final linear at zero."""
    params = dict(model.named_parameters())
    if not params:
        return model
    gen = torch.Generator(device=next(iter(params.values())).device)
    gen.manual_seed(int(seed))
    for name, p in sorted(params.items()):
        if name.endswith(".bias") or "adaLN_modulation" in name or name.startswith("final_layer"):
            p.zero_()
        elif name.startswith("t_embedder") or name.endswith("embedding_table.weight"):
            p.copy_(0.02 * torch.randn(p.shape, generator=gen, device=p.device))
        else:
            fan_out, fan_in = p.shape[0], p[0].numel()
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            p.copy_((2.0 * torch.rand(p.shape, generator=gen, device=p.device) - 1.0) * bound)
    return model
