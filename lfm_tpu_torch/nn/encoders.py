"""Condition encoders (port of lfm_tpu/nn/encoders.py; reference
models/encoder.py).

``SpatialRescaler`` (encoder.py:90-112) is the semantic-synthesis condition
encoder: n stages of bilinear resizing by ``multiplier`` and an optional
bias-free 1x1 channel map, one-hot segmentation (N, H, W, K) -> (N,
H/2^n, W/2^n, 4) at latent resolution, trained jointly with the velocity
net (reference downstream_tasks/train_flow_latent_semantic_syn.py:119,
128-132). The resize is ``F.interpolate(bilinear, align_corners=False,
antialias=False)``, which is what the JAX module's
``jax.image.resize(..., antialias=False)`` computes. The channel map is an
``nn.Linear`` over the channels named ``channel_mapper``, as the
reference's 1x1 convolution is; a reference ``(out, in, 1, 1)`` weight
loads into it as it is. Everything runs in f32.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class SpatialRescaler(nn.Module):
    def __init__(self, n_stages: int = 1, multiplier: float = 0.5, in_channels: int = 3,
                 out_channels: Optional[int] = None):
        super().__init__()
        self.n_stages = n_stages
        self.multiplier = multiplier
        self.channel_mapper = (None if out_channels is None
                               else nn.Linear(in_channels, out_channels, bias=False))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax Dense's lecun_normal: a normal cut at two standard
        deviations, scaled to variance 1 / fan_in."""
        if self.channel_mapper is not None:
            w = self.channel_mapper.weight
            std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "channel_mapper.weight"
        if key in state_dict and state_dict[key].dim() == 4:  # the reference's 1x1 conv
            state_dict[key] = state_dict[key][:, :, 0, 0]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C)."""
        x = x.float().permute(0, 3, 1, 2)
        for _ in range(self.n_stages):
            h, w = x.shape[2:]
            size = (int(h * self.multiplier), int(w * self.multiplier))
            x = F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                              antialias=False)
        x = x.permute(0, 2, 3, 1)
        if self.channel_mapper is not None:
            x = self.channel_mapper(x)
        return x


def rescaler_params_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """lfm_tpu's SpatialRescaler params (``{"params": ...}`` or the inner
    dict) -> this module's ``state_dict``: Dense kernel (in, out) -> Linear
    weight (out, in)."""
    p = flax_params.get("params", flax_params)
    if "channel_mapper" not in p:
        return {}
    kernel = np.asarray(p["channel_mapper"]["kernel"], np.float32)
    return {"channel_mapper.weight": torch.from_numpy(np.ascontiguousarray(kernel.T))}
