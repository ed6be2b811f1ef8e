"""Weight initialisation: the DiT's and the UNets' training inits, and seeded
random weights with every tensor non-zero.

``dit_init_`` gives a fresh DiT the JAX package's initializers (those of the
reference DiT, models/DiT.py:197-229), with other draws; ``unet_init_`` the
same for the origin ADM and EDM's DhariwalUNet (flax's defaults and their
zero-initialised layers). The repository
holds no trained checkpoint, so the checks use ``seeded_init_``, for the
DiT and the UNets alike: adaLN-Zero's zero init makes every DiT block an
identity, and the ADM's zero-initialised ``out_layers.3``, ``out.2`` and
attention ``proj_out`` (EDM's ``conv1``, ``proj`` and ``out_conv``) hide
their block, so a wrong attention, MLP or GroupNorm would still pass a
check; these weights give every tensor signal instead: weights N(0, 1/fan_in) (fan_in = in channels x kernel
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


# the zero-initialised layers of the UNets: the origin ADM's ResBlock out
# conv, attention projection and final conv (lfm_tpu/nn/adm_unet.py:202,
# 269, 406) and its SpatialTransformer's proj_out (lfm_tpu/nn/attention.py:
# 128), EDM's block conv1, attention and cross-attention proj, out_conv and
# SongUNet's aux_conv (lfm_tpu/nn/edm_unet.py:199, 223, 264, 614, 496)
_UNET_ZERO = ("out_layers.3.weight", "proj_out.weight", "out.2.weight", "conv1.weight",
              "proj.weight", "out_conv.weight", "aux_conv.weight")


@torch.no_grad()
def unet_init_(model: nn.Module, seed: int) -> nn.Module:
    """The JAX package's initializers for a fresh origin-ADM UNet or one of
    EDM's networks, with other draws: flax's default lecun_normal (a normal
    of variance 1 / fan_in truncated at two standard deviations) for
    convolution and dense weights, EDM's convolutions N(0, 1 / fan_in)
    (``EDMConv``), the ADM's label table N(0, 1 / classes) (flax ``Embed``),
    the context variant's ``LabelEmbedder`` table N(0, 0.02^2), NCSN++'s
    Fourier frequencies N(0, scale^2), zero biases, norm scales 1, and the
    zero-initialised layers at zero."""
    from lfm_tpu_torch.nn.attention import GEGLU
    from lfm_tpu_torch.nn.edm_unet import EDMConv, FourierEmbedding

    params = dict(model.named_parameters())
    if not params:
        return model
    gen = torch.Generator(device=next(iter(params.values())).device)
    gen.manual_seed(int(seed))
    norms = {f"{name}.weight" for name, m in model.named_modules()
             if isinstance(m, (nn.GroupNorm, nn.LayerNorm))}
    edm_convs = {f"{name}.weight" for name, m in model.named_modules()
                 if isinstance(m, EDMConv)}
    fourier = {f"{name}.freqs": m.scale for name, m in model.named_modules()
               if isinstance(m, FourierEmbedding)}
    # a GEGLU's ``proj`` is flax's default Dense, not a zero-initialised one
    geglu = {f"{name}.proj.weight" for name, m in model.named_modules() if isinstance(m, GEGLU)}
    for name, p in sorted(params.items()):
        if name.endswith(".bias") or (name.endswith(_UNET_ZERO) and name not in geglu):
            p.zero_()
        elif name in norms:
            p.fill_(1.0)
        elif name in fourier:
            p.copy_(fourier[name] * torch.randn(p.shape, generator=gen, device=p.device))
        elif name.endswith("embedding_table.weight"):
            p.copy_(0.02 * torch.randn(p.shape, generator=gen, device=p.device))
        elif name == "label_emb.weight":
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device) / math.sqrt(p.shape[0]))
        elif name in edm_convs:
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device)
                    / math.sqrt(p[0].numel()))
        else:
            std = math.sqrt(1.0 / p[0].numel()) / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    return model
