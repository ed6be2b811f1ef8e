"""The LDM cross-attention stack (port of lfm_tpu/nn/attention.py; reference
models/guided_diffusion/attention.py): ``SpatialTransformer`` conditions a
UNet feature map on a context sequence (1x1 ``proj_in``, ``depth``
``BasicTransformerBlock``s of self-attention, cross-attention and a GEGLU
feed-forward, a zero-initialised 1x1 ``proj_out``, residual). The layout
UNet (``UNetModel`` with ``use_spatial_transformer``) uses it;
``LinearAttention`` and ``SpatialSelfAttention`` complete the module.

Names are the reference's LDM ones: ``norm``, ``proj_in``,
``transformer_blocks.{d}.attn1.to_q | to_k | to_v | to_out.0``,
``.ff.net.0.proj``, ``.ff.net.2``, ``.norm1``-``norm3``, ``proj_out``;
1x1 convolutions keep the reference's (O, I, 1, 1) weights. NHWC.

Numerics are flax's, as the JAX module computes them: LayerNorm with eps
1e-6 and f32 statistics (E[x^2] - E[x]^2), cast to ``dtype``; GroupNorm of
32 groups, eps 1e-6, in f32; Dense layers in ``dtype`` (product and bias
rounded apart); scores from f32 products of the ``dtype`` q and k, the
softmax in f32 cast to ``dtype``, and the weighted sum in ``dtype``; exact
(erf) GELU. No hand-written kernel runs here: the JAX module's attention is
an einsum.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lfm_tpu_torch.nn.layers import dense, group_norm_f32, layer_norm, linear


def _conv1x1(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """A 1x1 convolution on the channels of NHWC (or (N, T, C)) x, as a
    Dense layer in ``dtype``."""
    return dense(x, conv.weight[:, :, 0, 0], conv.bias, dtype)


class FlaxLayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=...)``: f32 statistics with the fast
    variance, eps 1e-6, scale and bias in f32, cast to ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return (layer_norm(x, self.eps) * self.weight.float() + self.bias.float()).to(dtype)


class GEGLU(nn.Module):
    """(attention.py:85-92): x * GELU(gate), both halves of one Dense."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, 2 * dim_out)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x, gate = linear(x, self.proj, dtype).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    """(attention.py:95-105) as the transformer blocks build it, gated:
    GEGLU to ``mult`` x the width, dropout (off, as in the JAX module),
    Dense back."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return linear(self.net[0](x, dtype), self.net[2], dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            mask: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """softmax(q k^T scale) v over (N, T, heads, d) tensors in ``dtype``:
    the scores from f32 products, masked keys at f32's lowest value, the
    softmax in f32 cast to ``dtype``."""
    sim = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * scale
    if mask is not None:
        sim = torch.where(mask[:, None, None, :], sim, torch.finfo(torch.float32).min)
    attn = torch.softmax(sim, dim=-1).to(dtype)
    return torch.einsum("nhqk,nkhd->nqhd", attn, v)


class CrossAttention(nn.Module):
    """(attention.py:177-215): q from x, k and v from the context (x where
    there is none), ``heads`` of ``dim_head``; ``mask`` (N, keys) keeps the
    keys where it is true."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor, dtype: torch.dtype, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        n, tq, _ = x.shape
        h, d = self.heads, self.dim_head
        q = linear(x, self.to_q, dtype).view(n, tq, h, d)
        k = linear(context, self.to_k, dtype).view(n, -1, h, d)
        v = linear(context, self.to_v, dtype).view(n, -1, h, d)
        out = _attend(q, k, v, d ** -0.5, mask, dtype).reshape(n, tq, h * d)
        return linear(out, self.to_out[0], dtype)


class BasicTransformerBlock(nn.Module):
    """(attention.py:218-240): LayerNorm then self-attention, LayerNorm then
    cross-attention over the context, LayerNorm then the gated
    feed-forward, each added to x."""

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads=n_heads, dim_head=d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads=n_heads, dim_head=d_head)
        self.norm1 = FlaxLayerNorm(dim)
        self.norm2 = FlaxLayerNorm(dim)
        self.norm3 = FlaxLayerNorm(dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attn1(self.norm1(x, dtype), dtype) + x
        x = self.attn2(self.norm2(x, dtype), dtype, context=context) + x
        return self.ff(self.norm3(x, dtype), dtype) + x


class SpatialTransformer(nn.Module):
    """(attention.py:243-280): NHWC x (N, H, W, C), context (N, L,
    context_dim)."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = nn.GroupNorm(32, in_channels, eps=1e-6)
        self.proj_in = nn.Conv2d(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim) for _ in range(depth))
        self.proj_out = nn.Conv2d(inner, in_channels, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, h, w, _ = x.shape
        y = group_norm_f32(x, self.norm).to(dtype)
        y = _conv1x1(y, self.proj_in, dtype).reshape(n, h * w, -1)
        for block in self.transformer_blocks:
            y = block(y, dtype, context)
        y = _conv1x1(y.reshape(n, h, w, -1), self.proj_out, dtype)
        return y + x


class LinearAttention(nn.Module):
    """(attention.py:121-137): keys softmaxed over the tokens, one (d, d)
    context a head, queries read from it; NHWC."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, 3 * inner, 1, bias=False)
        self.to_out = nn.Conv2d(inner, dim, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        n, h, w, _ = x.shape
        qkv = dense(x, self.to_qkv.weight[:, :, 0, 0], None, dtype)
        q, k, v = qkv.view(n, h * w, 3, self.heads, self.dim_head).unbind(2)
        k = torch.softmax(k, dim=1)
        ctx = torch.einsum("nthd,nthe->nhde", k, v)
        out = torch.einsum("nhde,nthd->nthe", ctx, q).reshape(n, h, w, -1)
        return _conv1x1(out, self.to_out, dtype)


class SpatialSelfAttention(nn.Module):
    """(attention.py:140-174): one head over the H*W tokens, the VAE's
    spatial attention; NHWC, residual."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.norm = nn.GroupNorm(32, in_channels, eps=1e-6)
        self.q = nn.Conv2d(in_channels, in_channels, 1)
        self.k = nn.Conv2d(in_channels, in_channels, 1)
        self.v = nn.Conv2d(in_channels, in_channels, 1)
        self.proj_out = nn.Conv2d(in_channels, in_channels, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        n, h, w, c = x.shape
        y = group_norm_f32(x, self.norm).to(dtype).reshape(n, h * w, c)
        q, k, v = (_conv1x1(y, conv, dtype) for conv in (self.q, self.k, self.v))
        sim = torch.einsum("nqc,nkc->nqk", q.float(), k.float()) * c ** -0.5
        o = torch.einsum("nqk,nkc->nqc", torch.softmax(sim, dim=-1).to(dtype), v)
        return x + _conv1x1(o.reshape(n, h, w, c), self.proj_out, dtype)
