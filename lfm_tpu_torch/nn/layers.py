"""Shared building blocks of the DiT and the ADM UNet (port of
lfm_tpu/nn/layers.py).

Parameters are float32 masters; each module computes in its ``dtype`` and
casts the weights to it on use, as flax's ``Dense(dtype=...)`` and
``Conv(dtype=...)`` do. The LayerNorm and GroupNorm statistics and the
softmax stay float32. Module and parameter names follow the reference's
timm / models/DiT.py and guided-diffusion layouts, so a reference
``state_dict`` loads as it is.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lfm_tpu_torch.core.partition import copy_to_group, reduce_from_group
from lfm_tpu_torch.core.rng import draw_rows
from lfm_tpu_torch.kernels.flash_attention import (fused_attention_qkv, reference_attention,
                                                   split_qkv)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: x and the f32 weight cast to ``dtype``,
    the product rounded to ``dtype``, then the bias added in ``dtype`` (a
    second rounding, which a fused bias would skip)."""
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (flax Dense with dtype=...). A
    layer that core/partition.py split over a tensor group carries
    ``tensor_parallel = (kind, group)``: a column-split layer's input
    gradient is summed over the group, a row-split layer's partial products
    are summed before its bias is added."""
    tp = getattr(layer, "tensor_parallel", None)
    if tp is None:
        return dense(x, layer.weight, layer.bias, dtype)
    kind, group = tp
    if kind == "col":
        return dense(copy_to_group(x, group), layer.weight, layer.bias, dtype)
    y = reduce_from_group(dense(x, layer.weight, None, dtype), group)
    return y + layer.bias.to(dtype)


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype, stride=1, padding=0) -> torch.Tensor:
    """flax ``Conv(dtype=...)`` on NHWC x with the reference's (O, I, kh, kw)
    weight: the product rounded to ``dtype``, then the bias added in
    ``dtype``, as ``dense`` does. The convolution runs on the channels-last
    view of x, which cuDNN takes without a copy."""
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight.to(dtype), None,
                 stride, padding).permute(0, 2, 3, 1)
    return y + bias.to(dtype)


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``conv(x)`` on NHWC x computed in ``dtype`` (``conv2d_nhwc``)."""
    return conv2d_nhwc(x, conv.weight, conv.bias, dtype, conv.stride, conv.padding)


def group_norm_f32(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    """GroupNorm over NHWC x in float32 (``F.group_norm``'s two-pass
    statistics; flax's E[x^2] - E[x]^2 agrees to f32 rounding unless |mean|
    >> std); returns float32."""
    y = F.group_norm(x.float().permute(0, 3, 1, 2), gn.num_groups, gn.weight.float(),
                     gn.bias.float(), gn.eps)
    return y.permute(0, 2, 3, 1)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm computed in float32 whatever the activation type, cast back
    to it (models/guided_diffusion/nn.py:17-19): 32 groups, eps 1e-5, on
    NHWC."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_f32(x, self).to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout`` in train mode: each element kept with probability
    1 - rate (a uniform draw from ``generator`` below it) and scaled by
    1 / (1 - rate), else zero; x's type."""
    if rate <= 0.0:
        return x
    keep = draw_rows(torch.rand, x.shape, generator, x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """No-affine LayerNorm in float32 with flax's fast variance,
    max(E[x^2] - E[x]^2, 0); returns float32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp(xf.square().mean(dim=-1, keepdim=True) - mu.square(), min=0.0)
    return (xf - mu) * torch.rsqrt(var + eps)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation (models/DiT.py:20-21): x * (1 + scale) + shift."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal embedding, cos first (models/DiT.py:53-62). t: (N,)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """Fixed 2D sin-cos position table (models/DiT.py:299-346), (g*g, D)
    float32; the same numpy arithmetic as the JAX package."""

    def embed_1d(pos: np.ndarray) -> np.ndarray:
        omega = np.arange(embed_dim // 4, dtype=np.float64) / (embed_dim / 4.0)
        omega = 1.0 / 10_000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    gx, gy = np.meshgrid(grid_w, grid_h)
    emb = np.concatenate([embed_1d(gx), embed_1d(gy)], axis=1)
    return emb.astype(np.float32)


class TimestepEmbedder(nn.Module):
    """freq embedding -> Linear -> SiLU -> Linear (models/DiT.py:29-69)."""

    def __init__(self, hidden_size: int, freq_size: int = 256):
        super().__init__()
        self.freq_size = freq_size
        self.mlp = nn.Sequential(nn.Linear(freq_size, hidden_size), nn.SiLU(),
                                 nn.Linear(hidden_size, hidden_size))

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = timestep_embedding(t, self.freq_size).to(dtype)
        x = F.silu(linear(x, self.mlp[0], dtype))
        return linear(x, self.mlp[2], dtype)


class LabelEmbedder(nn.Module):
    """Class embedding table with a null row when dropout > 0
    (models/DiT.py:72-104). In train mode each label drops to the null row
    with probability ``dropout_prob``, drawn from ``generator``;
    ``force_drop_ids`` (1 = drop) pins the mask instead, in any mode."""

    def __init__(self, num_classes: int, hidden_size: int, dropout_prob: float = 0.0):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.embedding_table = nn.Embedding(num_classes + int(dropout_prob > 0), hidden_size)

    def forward(self, labels: torch.Tensor, dtype: torch.dtype, train: bool = False,
                generator: Optional[torch.Generator] = None,
                force_drop_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if (train and self.dropout_prob > 0) or force_drop_ids is not None:
            if force_drop_ids is None:
                drop = draw_rows(torch.rand, labels.shape, generator,
                                 labels.device) < self.dropout_prob
            else:
                drop = force_drop_ids == 1
            labels = torch.where(drop, self.num_classes, labels)
        return self.embedding_table.weight[labels].to(dtype)


class PatchEmbed(nn.Module):
    """Non-overlapping patchify (timm PatchEmbed; models/DiT.py:179).
    NHWC (N, H, W, C) -> tokens (N, H/p * W/p, D), row-major. The weight
    keeps the reference's conv layout (D, C, p, p); the stride-p conv is
    computed as reshape + matmul over (ph, pw, c)-ordered patches."""

    def __init__(self, patch_size: int, in_channels: int, hidden_size: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_channels, hidden_size, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        p = self.patch_size
        n, h, w, c = x.shape
        x = x.reshape(n, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(n, (h // p) * (w // p), p * p * c)
        wt = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.weight.shape[0], -1)
        return dense(x, wt, self.proj.bias, dtype)


class Attention(nn.Module):
    """Fused-qkv multi-head self-attention (timm layout). With ``use_flash``
    every attention goes through kernels.flash_attention.fused_attention_qkv,
    which launches ``attention_small`` (K1) forward and
    ``attention_small_bwd`` (K3) backward on a CUDA tensor."""

    def __init__(self, hidden_size: int, num_heads: int, qkv_bias: bool = True,
                 use_flash: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.qkv = nn.Linear(hidden_size, 3 * hidden_size, bias=qkv_bias)
        self.proj = nn.Linear(hidden_size, hidden_size)

    def attend(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The qkv product and the attention, up to the output projection:
        (N, T, C). Its output is the JAX package's ``attn_out``, which the
        ``dots_attn`` remat policy saves (nn/dit.py)."""
        n, t, d = x.shape
        qkv = linear(x, self.qkv, dtype)
        # the kernels read the (T, H*D) rows of q, k, v in place
        if self.use_flash:
            out = fused_attention_qkv(qkv, self.num_heads)
        else:
            out = reference_attention(*split_qkv(qkv, self.num_heads))
        return out.reshape(n, t, -1)  # C / tp wide under tensor parallelism

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return linear(self.attend(x, dtype), self.proj, dtype)


class Mlp(nn.Module):
    """Linear -> GELU(tanh) -> Linear (timm Mlp; models/DiT.py:122-124)."""

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = F.gelu(linear(x, self.fc1, dtype), approximate="tanh")
        return linear(x, self.fc2, dtype)
