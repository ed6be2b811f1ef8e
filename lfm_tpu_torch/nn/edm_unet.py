"""EDM's networks (port of lfm_tpu/nn/edm_unet.py; reference
models/EDM.py:63-939): DhariwalUNet (ffhq_adm, bed_adm, imnet_adm), its
context variant (``adm_context``) and SongUNet (``ncsn++``, ``ddpm++``).
Activations are NHWC, as in the JAX package.

Module and parameter names are the reference's, so a released
``model_{E}.pth`` loads with ``load_state_dict``: ``map_noise`` (NCSN++'s
Fourier ``freqs``), ``map_label``, ``map_augment``, ``map_layer0``,
``map_layer1``, ``enc.{res}x{res}_conv``, ``enc.{res}x{res}_down``,
``enc.{res}x{res}_block{i}``, SongUNet's ``enc.{res}x{res}_aux_down``,
``_aux_skip`` and ``_aux_residual``, ``dec.{res}x{res}_in{0,1}``,
``dec.{res}x{res}_up``, ``dec.{res}x{res}_block{i}``, SongUNet's
``dec.{res}x{res}_aux_up``, ``_aux_norm`` and ``_aux_conv``, DhariwalUNet's
``out_norm`` and ``out_conv``; in a block ``norm0``, ``conv0``, ``affine``,
``norm1``, ``conv1``, ``skip``, and with attention ``norm2``, ``qkv`` and
``proj`` as 1x1 convolutions. A context block holds the plain block as
``base`` and its ``transformer`` (``norm1``, ``attn1``, ``norm2``,
``attn2``, ``norm3``, ``ff_layer0``, ``ff_layer1``; an attention's ``q``,
``k``, ``v`` and ``proj`` as Linear layers). A resampling convolution holds
the reference's ``resample_filter`` buffer.

Dtypes follow the JAX module: convolutions and Dense layers in ``dtype``
with the product and the bias rounded apart (``layers.dense``); GroupNorm
in f32 with ``min(32, C // 4)`` groups, cast back; the attentions' q, k, v,
scores, softmax and projection in f32 whatever ``dtype``, with the (head,
ch, 3) qkv layout and k scaled by 1/sqrt(d) before the product. TF32 is off
within ``forward``, so an f32 network is f32 on the card. No hand-written
kernel runs here: the JAX module's attentions are einsums and its GroupNorm
flax's, none a Pallas kernel.

The class label enters DhariwalUNet and SongUNet as a one-hot row, and a
label outside ``[0, label_dim)``, such as CFG's null label -1, gives the
zero row, as ``jax.nn.one_hot`` does (the reference's drop_half_label
zeroing, EDM.py:825-826). The context variant embeds it with a
``LabelEmbedder`` table, gathered with ``weight[labels]``: -1 takes the
last row, as JAX's gather does. NCSN++'s Fourier ``freqs`` is a trained
parameter, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from lfm_tpu_torch.core.config import ModelConfig
from lfm_tpu_torch.core.device import DeviceLike, no_tf32, resolve_device
from lfm_tpu_torch.core.rng import draw_rows
from lfm_tpu_torch.nn.layers import (LabelEmbedder, conv2d_nhwc, dense, dropout,
                                     group_norm_f32, linear)


# DhariwalUNet's and DDPM++'s resampling filter (EDM.py:725); NCSN++ takes
# [1, 3, 3, 1]
RESAMPLE_FILTER = (1.0, 1.0)


def resample_kernel(filt: Sequence[float] = RESAMPLE_FILTER) -> torch.Tensor:
    """The reference's ``resample_filter`` buffer: outer(f, f) / sum(f)^2,
    shape (1, 1, k, k)."""
    f = torch.as_tensor(filt, dtype=torch.float32)
    return (torch.outer(f, f) / f.sum().square())[None, None]


def depthwise_down(x: torch.Tensor, kernel: torch.Tensor, pad: Optional[int] = None
                   ) -> torch.Tensor:
    """conv2d with the (1, 1, k, k) filter on every channel, stride 2, on
    NHWC x (EDM.py:124-127); ``pad`` defaults to (k - 1) // 2."""
    c = x.shape[-1]
    pad = (kernel.shape[-1] - 1) // 2 if pad is None else pad
    w = kernel.to(x.dtype).tile(c, 1, 1, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=2, padding=pad, groups=c)
    return y.permute(0, 2, 3, 1)


def depthwise_up(x: torch.Tensor, kernel: torch.Tensor, pad: Optional[int] = None
                 ) -> torch.Tensor:
    """conv_transpose2d with 4x the filter on every channel, stride 2, on
    NHWC x (EDM.py:120-123); ``pad`` defaults to (k - 1) // 2."""
    c = x.shape[-1]
    pad = (kernel.shape[-1] - 1) // 2 if pad is None else pad
    w = (kernel * 4).to(x.dtype).tile(c, 1, 1, 1)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=2, padding=pad, groups=c)
    return y.permute(0, 2, 3, 1)


def positional_embedding(t: torch.Tensor, num_channels: int, endpoint: bool = False
                         ) -> torch.Tensor:
    """[cos | sin] of t times 10000^(-i / (half - endpoint)) (EDM
    PositionalEmbedding, EDM.py:490-509). t: (N,); returns (N, num_channels)
    f32."""
    half = num_channels // 2
    freqs = torch.arange(half, dtype=torch.float32, device=t.device) / (half - int(endpoint))
    freqs = (1.0 / 10_000.0) ** freqs
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=1)


class FourierEmbedding(nn.Module):
    """NCSN++'s random-frequency embedding (EDM.py:512-522): [cos | sin] of
    t times 2 pi ``freqs``, a parameter of ``num_channels // 2`` draws of
    N(0, scale^2)."""

    def __init__(self, num_channels: int, scale: float = 16.0):
        super().__init__()
        self.scale = scale
        self.freqs = nn.Parameter(torch.randn(num_channels // 2) * scale)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        args = t.float()[:, None] * (2.0 * math.pi * self.freqs)[None]
        return torch.cat([torch.cos(args), torch.sin(args)], dim=1)


class EDMConv(nn.Module):
    """The reference's Conv2d (EDM.py:63-132): an optional 2x up or down
    resample with ``resample_filter``, then a kxk convolution; with
    ``fused_resample`` the up-sampling runs before a convolution with less
    padding, and the down-sampling after one with more. ``kernel=0``
    resamples only and has no weights. ``init_scale=0`` starts the weight
    at zero, as the JAX module's zero-initialised layers."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, up: bool = False,
                 down: bool = False, resample_filter: Sequence[float] = RESAMPLE_FILTER,
                 fused_resample: bool = False, init_scale: float = 1.0):
        super().__init__()
        self.out_channels = out_channels
        self.up, self.down = up, down
        self.fused_resample = fused_resample
        self.weight = self.bias = None
        if kernel:
            fan_in = in_channels * kernel * kernel
            self.weight = nn.Parameter(
                torch.randn(out_channels, in_channels, kernel, kernel) * init_scale
                / math.sqrt(fan_in))
            self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("resample_filter",
                             resample_kernel(resample_filter) if up or down else None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype)
        f = self.resample_filter
        if self.weight is None:
            if self.up:
                return depthwise_up(x, f)
            return depthwise_down(x, f) if self.down else x
        w_pad = self.weight.shape[-1] // 2
        f_pad = 0 if f is None else (f.shape[-1] - 1) // 2
        if self.fused_resample and self.up:
            x = depthwise_up(x, f, pad=max(f_pad - w_pad, 0))
            return conv2d_nhwc(x, self.weight, self.bias, dtype, padding=max(w_pad - f_pad, 0))
        if self.fused_resample and self.down:
            h = conv2d_nhwc(x, self.weight, self.bias, dtype, padding=w_pad + f_pad)
            return depthwise_down(h, f, pad=0)
        if self.up:
            x = depthwise_up(x, f)
        if self.down:
            x = depthwise_down(x, f)
        return conv2d_nhwc(x, self.weight, self.bias, dtype, padding=w_pad)

    def as_dense(self) -> torch.Tensor:
        """A 1x1 convolution's weight as a (out, in) matrix."""
        return self.weight[:, :, 0, 0]


class EDMGroupNorm(nn.GroupNorm):
    """GroupNorm of min(32, C // 4) groups (EDM.py:139-151), eps 1e-5 unless
    given (SongUNet's 1e-6), computed in f32 on NHWC x and cast back to x's
    type."""

    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__(min(32, num_channels // 4), num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_f32(x, self).to(x.dtype)


def _attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q (k / sqrt(d))^T) v over (N, T, heads, d) f32 tensors, as the
    JAX module's einsums (EDM.py:160-179)."""
    w = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q, k / math.sqrt(q.shape[-1])), dim=-1)
    return torch.einsum("nhqk,nkhd->nqhd", w, v)


class EDMUNetBlock(nn.Module):
    """The reference's UNetBlock (EDM.py:188-292): GroupNorm, SiLU, conv
    (resampling); the embedding as scale and shift around the second
    GroupNorm (``adaptive_scale``, DhariwalUNet) or added before it
    (SongUNet); SiLU, dropout, a zero-initialised conv; the skip (a 1x1 conv
    where the width changes or ``resample_proj``, else a bare resample where
    the block resamples), the sum times ``skip_scale``; then, with
    ``attention``, f32 self-attention (``num_heads``, else 64 channels a
    head), its sum times ``skip_scale`` again."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 up: bool = False, down: bool = False, attention: bool = False,
                 num_heads: Optional[int] = None,
                 dropout: float = 0.0, skip_scale: float = 1.0, eps: float = 1e-5,
                 resample_filter: Sequence[float] = RESAMPLE_FILTER,
                 resample_proj: bool = False, adaptive_scale: bool = True):
        super().__init__()
        self.out_channels = out_channels
        self.num_heads = 0 if not attention else (
            num_heads if num_heads is not None else out_channels // 64)
        self.dropout = dropout
        self.skip_scale = skip_scale
        self.adaptive_scale = adaptive_scale
        self.norm0 = EDMGroupNorm(in_channels, eps)
        self.conv0 = EDMConv(in_channels, out_channels, 3, up=up, down=down,
                             resample_filter=resample_filter)
        self.affine = nn.Linear(emb_channels, out_channels * (2 if adaptive_scale else 1))
        self.norm1 = EDMGroupNorm(out_channels, eps)
        self.conv1 = EDMConv(out_channels, out_channels, 3, init_scale=0.0)
        self.skip = None
        if out_channels != in_channels or up or down:
            kernel = 1 if resample_proj or out_channels != in_channels else 0
            self.skip = EDMConv(in_channels, out_channels, kernel, up=up, down=down,
                                resample_filter=resample_filter)
        if self.num_heads:
            self.norm2 = EDMGroupNorm(out_channels, eps)
            self.qkv = EDMConv(out_channels, 3 * out_channels, 1)
            self.proj = EDMConv(out_channels, out_channels, 1, init_scale=0.0)

    def _scaled(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.skip_scale == 1.0 else x * self.skip_scale

    def forward(self, x: torch.Tensor, emb: torch.Tensor, dtype: torch.dtype,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = self.conv0(F.silu(self.norm0(x)), dtype)
        e = linear(emb, self.affine, dtype)
        if self.adaptive_scale:
            scale, shift = e.chunk(2, dim=-1)
            h = F.silu(shift[:, None, None, :] + self.norm1(h) * (scale[:, None, None, :] + 1.0))
        else:
            h = F.silu(self.norm1(h + e[:, None, None, :].to(h.dtype)))
        if train:
            h = dropout(h, self.dropout, generator)
        h = self.conv1(h, dtype)
        x = self._scaled(h + (x if self.skip is None else self.skip(x, dtype)))
        if not self.num_heads:
            return x
        n, hh, ww, c = x.shape
        t, heads = hh * ww, self.num_heads
        y = self.norm2(x).reshape(n, t, c)
        qkv = dense(y, self.qkv.as_dense(), self.qkv.bias, torch.float32)
        # the reference's layout: a channel index is (head, ch, 3)
        # (EDM.py:277-281)
        q, k, v = qkv.view(n, t, heads, c // heads, 3).unbind(-1)
        a = _attention_f32(q, k, v).reshape(n, t, c)
        a = dense(a, self.proj.as_dense(), self.proj.bias, torch.float32)
        return self._scaled(x + a.reshape(n, hh, ww, c).to(x.dtype))


class EDMCrossAttention(nn.Module):
    """(EDM.py:369-424): q from the feature map's tokens, k and v from the
    context's (or the tokens' where there is none), heads of 64 channels,
    all in f32, the output cast to the tokens' type; ``proj`` starts at
    zero."""

    def __init__(self, query_channels: int, context_channels: int):
        super().__init__()
        c = query_channels
        self.num_heads = c // 64
        self.q = nn.Linear(c, c)
        self.k = nn.Linear(context_channels, c)
        self.v = nn.Linear(context_channels, c)
        self.proj = nn.Linear(c, c)

    def forward(self, x_tokens: torch.Tensor, context: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        ctx = (x_tokens if context is None else context).float()
        n, tq, c = x_tokens.shape
        heads = self.num_heads
        q = linear(x_tokens.float(), self.q, torch.float32).view(n, tq, heads, c // heads)
        k = linear(ctx, self.k, torch.float32).view(n, -1, heads, c // heads)
        v = linear(ctx, self.v, torch.float32).view(n, -1, heads, c // heads)
        a = _attention_f32(q, k, v).reshape(n, tq, c)
        return linear(a, self.proj, torch.float32).to(x_tokens.dtype)


class EDMTransformerBlock(nn.Module):
    """(EDM.py:444-483): GroupNorm then self-attention, GroupNorm then
    cross-attention over the context, GroupNorm then a SiLU MLP of 4x the
    width, each added to the NHWC feature map."""

    def __init__(self, channels: int, context_channels: int):
        super().__init__()
        self.norm1 = EDMGroupNorm(channels)
        self.attn1 = EDMCrossAttention(channels, channels)
        self.norm2 = EDMGroupNorm(channels)
        self.attn2 = EDMCrossAttention(channels, context_channels)
        self.norm3 = EDMGroupNorm(channels)
        self.ff_layer0 = nn.Linear(channels, 4 * channels)
        self.ff_layer1 = nn.Linear(4 * channels, channels)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor], dtype: torch.dtype
                ) -> torch.Tensor:
        n, h, w, c = x.shape
        if context is not None and context.dim() == 2:
            context = context[:, None, :]  # (N, 1, Cc)
        x = x + self.attn1(self.norm1(x).reshape(n, h * w, c)).reshape(n, h, w, c)
        x = x + self.attn2(self.norm2(x).reshape(n, h * w, c), context).reshape(n, h, w, c)
        y = self.norm3(x).reshape(n, h * w, c)
        y = linear(F.silu(linear(y, self.ff_layer0, dtype)), self.ff_layer1, dtype)
        return x + y.reshape(n, h, w, c)


class EDMUNetBlockWithContext(nn.Module):
    """UNetBlock whose attention is a context transformer block
    (EDM.py:295-367): ``base`` (the block without attention), then with
    ``attention`` the ``transformer``."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 context_channels: int, attention: bool = False, **block):
        super().__init__()
        self.out_channels = out_channels
        self.base = EDMUNetBlock(in_channels, out_channels, emb_channels, **block)
        self.transformer = EDMTransformerBlock(
            out_channels, context_channels) if attention else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor, context: Optional[torch.Tensor],
                dtype: torch.dtype, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.base(x, emb, dtype, train, generator)
        if self.transformer is None:
            return x
        return self.transformer(x, context, dtype)


def _one_hot(y: torch.Tensor, label_dim: int) -> torch.Tensor:
    """``jax.nn.one_hot`` in f32: a label outside [0, label_dim) is the zero
    row."""
    return (y.reshape(-1, 1) == torch.arange(label_dim, device=y.device)).float()


class DhariwalUNet(nn.Module):
    """Velocity network v(t, x, y) (EDM.py:716-861); x: (N, H, W, C) NHWC
    latents. Parameters are f32 masters; ``dtype`` is the compute type.
    With ``use_context`` (``adm_context``) each block is a
    ``EDMUNetBlockWithContext`` and the label enters as a context sequence
    of one ``LabelEmbedder`` row (EDM.py:754-756, 828-829), not the
    embedding."""

    def __init__(self, img_resolution: int, in_channels: int = 4, out_channels: int = 4,
                 label_dim: int = 0, model_channels: int = 192,
                 channel_mult: Sequence[int] = (1, 2, 3, 4), num_blocks: int = 3,
                 attn_resolutions: Sequence[int] = (32, 16, 8), dropout: float = 0.10,
                 label_dropout: float = 0.0, use_context: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model_channels = model_channels
        self.label_dim = label_dim
        self.label_dropout = label_dropout
        self.use_context = use_context
        self.dtype = dtype
        emb_ch = 4 * model_channels
        self.map_layer0 = nn.Linear(model_channels, emb_ch)
        self.map_layer1 = nn.Linear(emb_ch, emb_ch)
        self.map_label = None
        if label_dim and use_context:
            self.map_label = LabelEmbedder(label_dim, emb_ch, label_dropout)
        elif label_dim:
            self.map_label = nn.Linear(label_dim, emb_ch, bias=False)

        def block(cin, cout, attention=False, **kw):
            if use_context:
                # the context is the label row, else the block's own tokens
                return EDMUNetBlockWithContext(cin, cout, emb_ch, emb_ch if label_dim else cout,
                                               attention=attention, dropout=dropout, **kw)
            return EDMUNetBlock(cin, cout, emb_ch, attention=attention, dropout=dropout, **kw)

        self.enc = nn.ModuleDict()
        cout = in_channels
        for level, mult in enumerate(channel_mult):
            res = img_resolution >> level
            if level == 0:
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_conv"] = EDMConv(cin, cout, 3)
            else:
                self.enc[f"{res}x{res}_down"] = block(cout, cout, down=True)
            for idx in range(num_blocks):
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_block{idx}"] = block(cin, cout, res in attn_resolutions)
        skips = [b.out_channels for b in self.enc.values()]

        self.dec = nn.ModuleDict()
        for level, mult in reversed(list(enumerate(channel_mult))):
            res = img_resolution >> level
            if level == len(channel_mult) - 1:
                self.dec[f"{res}x{res}_in0"] = block(cout, cout, True)
                self.dec[f"{res}x{res}_in1"] = block(cout, cout)
            else:
                self.dec[f"{res}x{res}_up"] = block(cout, cout, up=True)
            for idx in range(num_blocks + 1):
                cin, cout = cout + skips.pop(), model_channels * mult
                self.dec[f"{res}x{res}_block{idx}"] = block(cin, cout, res in attn_resolutions)
        self.out_norm = EDMGroupNorm(cout)
        self.out_conv = EDMConv(cout, out_channels, 3, init_scale=0.0)

    @property
    def null_label(self) -> int:
        """CFG's null label: one_hot(-1) is the zero row, the reference's
        drop_half_label zeroing (EDM.py:825-826); the context variant's
        table gather takes the last row for it, as the JAX package's does."""
        return -1

    def forward(self, t: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                train: bool = False, drop_half_label: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """v(t, x, y) in f32. ``train`` turns dropout and label dropout on,
        their masks drawn from ``generator`` (the label mask first, then the
        blocks' in order); ``drop_half_label`` zeroes the second half's
        labels (CFG on a doubled batch; the context variant ignores it, as
        the JAX package's does)."""
        n = x.shape[0]
        dt = self.dtype
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(n)
        with no_tf32():
            emb = positional_embedding(t, self.model_channels)
            emb = F.silu(linear(emb, self.map_layer0, dt))
            emb = linear(emb, self.map_layer1, dt)
            context = None
            if self.use_context and self.map_label is not None:
                context = self.map_label(y, dt, train, generator)
            elif self.map_label is not None and y is not None:
                onehot = _one_hot(y, self.label_dim)
                if train and self.label_dropout > 0:
                    keep = draw_rows(torch.rand, (n, 1), generator,
                                     x.device) >= self.label_dropout
                    onehot = onehot * keep
                elif drop_half_label:
                    onehot = onehot * (torch.arange(n, device=x.device) < n // 2)[:, None]
                emb = emb + dense(onehot, self.map_label.weight, None, dt)
            emb = F.silu(emb)

            def run(layer, h):
                if self.use_context:
                    return layer(h, emb, context, dt, train, generator)
                return layer(h, emb, dt, train, generator)

            h = x.to(dt)
            skips = []
            for name, layer in self.enc.items():
                h = layer(h, dt) if name.endswith("_conv") else run(layer, h)
                skips.append(h)
            for name, layer in self.dec.items():
                if "_block" in name:
                    h = torch.cat([h, skips.pop()], dim=-1)
                h = run(layer, h)
            h = self.out_conv(F.silu(self.out_norm(h)), dt)
        return h.float()

    def forward_with_cfg(self, t: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                         cfg_scale: float = 1.0) -> torch.Tensor:
        """Drop-half-label CFG on a doubled batch (EDM.py:847-861): the
        first half of x twice, labels kept on the first copy."""
        n = x.shape[0] // 2
        half = x[:n]
        out = self(t, torch.cat([half, half]), y, drop_half_label=True)
        cond, uncond = out[:n], out[n:]
        guided = uncond + cfg_scale * (cond - uncond)
        return torch.cat([guided, guided])


class SongUNet(nn.Module):
    """DDPM++ / NCSN++ (EDM.py:532-706): the noise embedding (positional with
    the endpoint, or ``FourierEmbedding``) with its sin and cos halves
    swapped, the label as a one-hot row times sqrt(label_dim) through a
    biased ``map_label``, the augmentation labels through ``map_augment``;
    blocks with the additive embedding, skip_scale sqrt(1/2), eps 1e-6, one
    attention head and 1x1 resampling skips; the encoder's ``standard``,
    ``skip`` or ``residual`` auxiliary path, and the decoder's ``standard``
    or ``skip`` output path. x: (N, H, W, C) NHWC latents; parameters are
    f32 masters, ``dtype`` the compute type."""

    def __init__(self, img_resolution: int, in_channels: int = 4, out_channels: int = 4,
                 label_dim: int = 0, augment_dim: int = 0, model_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 2, 2, 2), channel_mult_emb: int = 4,
                 num_blocks: int = 4, attn_resolutions: Sequence[int] = (16,),
                 dropout: float = 0.10, label_dropout: float = 0.0,
                 embedding_type: str = "positional", channel_mult_noise: int = 1,
                 encoder_type: str = "standard", decoder_type: str = "standard",
                 resample_filter: Sequence[float] = RESAMPLE_FILTER,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if encoder_type not in ("standard", "skip", "residual"):
            raise ValueError(f"unknown encoder_type {encoder_type!r}")
        if decoder_type not in ("standard", "skip"):
            raise ValueError(f"unknown decoder_type {decoder_type!r}")
        self.label_dim = label_dim
        self.label_dropout = label_dropout
        self.embedding_type = embedding_type
        self.encoder_type, self.decoder_type = encoder_type, decoder_type
        self.dtype = dtype
        emb_ch = model_channels * channel_mult_emb
        self.noise_channels = noise_ch = model_channels * channel_mult_noise
        self.map_noise = FourierEmbedding(noise_ch) if embedding_type == "fourier" else None
        self.map_label = nn.Linear(label_dim, noise_ch) if label_dim else None
        self.map_augment = nn.Linear(augment_dim, noise_ch, bias=False) if augment_dim else None
        self.map_layer0 = nn.Linear(noise_ch, emb_ch)
        self.map_layer1 = nn.Linear(emb_ch, emb_ch)
        block = dict(emb_channels=emb_ch, num_heads=1, dropout=dropout,
                     skip_scale=math.sqrt(0.5), eps=1e-6, resample_filter=resample_filter,
                     resample_proj=True, adaptive_scale=False)

        self.enc = nn.ModuleDict()
        cout = caux = in_channels
        for level, mult in enumerate(channel_mult):
            res = img_resolution >> level
            if level == 0:
                cin, cout = cout, model_channels
                self.enc[f"{res}x{res}_conv"] = EDMConv(cin, cout, 3)
            else:
                self.enc[f"{res}x{res}_down"] = EDMUNetBlock(cout, cout, down=True, **block)
                if encoder_type == "skip":
                    self.enc[f"{res}x{res}_aux_down"] = EDMConv(
                        caux, caux, 0, down=True, resample_filter=resample_filter)
                    self.enc[f"{res}x{res}_aux_skip"] = EDMConv(caux, cout, 1)
                elif encoder_type == "residual":
                    self.enc[f"{res}x{res}_aux_residual"] = EDMConv(
                        caux, cout, 3, down=True, resample_filter=resample_filter,
                        fused_resample=True)
                    caux = cout
            for idx in range(num_blocks):
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_block{idx}"] = EDMUNetBlock(
                    cin, cout, attention=res in attn_resolutions, **block)
        skips = [b.out_channels for name, b in self.enc.items() if "_aux_" not in name]

        self.dec = nn.ModuleDict()
        for level, mult in reversed(list(enumerate(channel_mult))):
            res = img_resolution >> level
            if level == len(channel_mult) - 1:
                self.dec[f"{res}x{res}_in0"] = EDMUNetBlock(cout, cout, attention=True, **block)
                self.dec[f"{res}x{res}_in1"] = EDMUNetBlock(cout, cout, **block)
            else:
                self.dec[f"{res}x{res}_up"] = EDMUNetBlock(cout, cout, up=True, **block)
            for idx in range(num_blocks + 1):
                cin, cout = cout + skips.pop(), model_channels * mult
                self.dec[f"{res}x{res}_block{idx}"] = EDMUNetBlock(
                    cin, cout, attention=idx == num_blocks and res in attn_resolutions,
                    **block)
            if decoder_type == "skip" or level == 0:
                if decoder_type == "skip" and level < len(channel_mult) - 1:
                    self.dec[f"{res}x{res}_aux_up"] = EDMConv(
                        out_channels, out_channels, 0, up=True, resample_filter=resample_filter)
                self.dec[f"{res}x{res}_aux_norm"] = EDMGroupNorm(cout, eps=1e-6)
                self.dec[f"{res}x{res}_aux_conv"] = EDMConv(cout, out_channels, 3,
                                                            init_scale=0.0)

    @property
    def null_label(self) -> int:
        """CFG's null label: one_hot(-1) is the zero row (EDM.py:825-826)."""
        return -1

    def forward(self, t: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                augment_labels: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """v(t, x, y) in f32. ``train`` turns dropout and label dropout on,
        their masks drawn from ``generator`` (the label mask first, then the
        blocks' in order)."""
        n = x.shape[0]
        dt = self.dtype
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(n)
        with no_tf32():
            if self.map_noise is None:
                emb = positional_embedding(t, self.noise_channels, endpoint=True)
            else:
                emb = self.map_noise(t)
            emb = emb.reshape(n, 2, -1).flip(1).reshape(n, -1)  # sin | cos (EDM.py:666)
            if self.map_label is not None:
                if y is None:
                    raise ValueError("a class-conditional SongUNet needs y")
                onehot = _one_hot(y, self.label_dim)
                if train and self.label_dropout > 0:
                    keep = draw_rows(torch.rand, (n, 1), generator,
                                     x.device) >= self.label_dropout
                    onehot = onehot * keep
                emb = emb + linear(onehot * math.sqrt(self.label_dim), self.map_label, dt)
            if self.map_augment is not None and augment_labels is not None:
                emb = emb + linear(augment_labels, self.map_augment, dt)
            emb = F.silu(linear(emb, self.map_layer0, dt))
            emb = F.silu(linear(emb, self.map_layer1, dt))

            h = aux = x.to(dt)
            skips: List[torch.Tensor] = []
            for name, layer in self.enc.items():
                if name.endswith("_conv"):
                    h = layer(h, dt)
                elif name.endswith("_aux_down"):
                    aux = layer(aux, dt)
                    continue
                elif name.endswith("_aux_skip"):
                    h = skips[-1] = h + layer(aux, dt)
                    continue
                elif name.endswith("_aux_residual"):
                    h = skips[-1] = aux = (h + layer(aux, dt)) / math.sqrt(2.0)
                    continue
                else:
                    h = layer(h, emb, dt, train, generator)
                skips.append(h)

            aux = tmp = None
            for name, layer in self.dec.items():
                if name.endswith("_aux_up"):
                    aux = layer(aux, dt)
                elif name.endswith("_aux_norm"):
                    tmp = layer(h)
                elif name.endswith("_aux_conv"):
                    tmp = layer(F.silu(tmp), dt)
                    aux = tmp if aux is None else tmp + aux
                else:
                    if "_block" in name:
                        h = torch.cat([h, skips.pop()], dim=-1)
                    h = layer(h, emb, dt, train, generator)
        return aux.float()


EDMNetwork = Union[DhariwalUNet, SongUNet]


def create_edm_network(cfg: ModelConfig, *, dtype: torch.dtype = torch.float32,
                       device: DeviceLike = None) -> EDMNetwork:
    """Factory for EDM's networks (reference models/EDM.py:864-939), built on
    ``device`` (the card unless ``device="cpu"``): ``ncsn++`` (SongUNet with
    the Fourier embedding, the residual encoder and the [1, 3, 3, 1]
    filter), ``ddpm++`` (SongUNet, positional), ``adm`` (DhariwalUNet) and
    ``adm_context`` (DhariwalUNet with the context blocks)."""
    common = dict(img_resolution=cfg.latent_size, in_channels=cfg.num_in_channels,
                  out_channels=cfg.num_out_channels, label_dim=cfg.label_dim,
                  model_channels=cfg.nf, channel_mult=tuple(cfg.ch_mult),
                  num_blocks=cfg.num_res_blocks, attn_resolutions=tuple(cfg.attn_resolutions),
                  dropout=cfg.dropout, label_dropout=cfg.label_dropout, dtype=dtype)
    song = {"ncsn++": dict(embedding_type="fourier", channel_mult_noise=2,
                           encoder_type="residual", resample_filter=(1.0, 3.0, 3.0, 1.0)),
            "ddpm++": dict(embedding_type="positional", channel_mult_noise=1,
                           encoder_type="standard", resample_filter=(1.0, 1.0))}
    if cfg.model_type not in ("adm", "adm_context", *song):
        raise ValueError(f"unknown EDM model_type {cfg.model_type!r}")
    device = resolve_device(device)
    with device:
        if cfg.model_type in song:
            model = SongUNet(channel_mult_emb=4, **song[cfg.model_type], **common)
        else:
            model = DhariwalUNet(use_context=cfg.model_type == "adm_context", **common)
    return model.to(device)
