"""First-stage AutoencoderKL (port of lfm_tpu/vae/autoencoder_kl.py).

The SD VAE (f=8, ``block_out`` (128, 256, 512, 512), 2 encoder / 3 decoder
resnets per level, mid-block attention, a diagonal Gaussian latent of 4
channels) that the reference loads from ``stabilityai/sd-vae-ft-mse``.
Module and parameter names follow diffusers
(``encoder.down_blocks.{i}.resnets.{j}.conv1``,
``decoder.up_blocks.{i}.resnets.{j}.conv1``, ``mid_block.attentions.0.to_q``,
``quant_conv``, ``post_quant_conv``), so a diffusers state dict loads through
``vae/convert.py::load_vae_state_dict``.

The public ``encode_*`` and ``decode`` take and return NHWC, as in the JAX
package; inside, the convolutions are ``torch.nn.functional.conv2d`` on
NCHW (the JAX package leaves them to XLA; cuDNN here). GroupNorm runs in
f32 with flax's statistics (E[x^2] - E[x]^2), eps 1e-6. Encode and decode
turn TF32 off for their own duration, for both cuDNN convolutions and
matmuls (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``), so an f32 VAE is f32 on the
card; bf16 is unaffected.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lfm_tpu_torch.core.device import DeviceLike, no_tf32, resolve_device
from lfm_tpu_torch.nn.layers import dense

_GN_EPS = 1e-6


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Conv(dtype=...)`` on NCHW x: the product rounded to ``dtype``,
    then the bias added in ``dtype`` (a second rounding, which a fused bias
    would skip; in f32 the two agree)."""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride, conv.padding)
    return y + conv.bias.to(dtype)[:, None, None]


def _linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``, rounded as ``_conv``."""
    return dense(x, lin.weight, lin.bias, dtype)


def group_norm(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    """flax GroupNorm in f32 on NCHW: per-group mean and E[x^2] - mean^2."""
    n, c = x.shape[:2]
    g = gn.num_groups
    xf = x.float().reshape(n, g, -1)
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp(xf.square().mean(dim=-1, keepdim=True) - mu.square(), min=0.0)
    y = ((xf - mu) * torch.rsqrt(var + gn.eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return y * gn.weight.float().reshape(shape) + gn.bias.float().reshape(shape)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, in_ch, eps=_GN_EPS)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(32, out_ch, eps=_GN_EPS)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = F.silu(group_norm(x, self.norm1).to(dtype))
        h = _conv(h, self.conv1, dtype)
        h = F.silu(group_norm(h, self.norm2).to(dtype))
        h = _conv(h, self.conv2, dtype)
        if self.conv_shortcut is not None:
            x = _conv(x, self.conv_shortcut, dtype)
        return x.to(dtype) + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over H*W positions (mid block)."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(32, ch, eps=_GN_EPS)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        n, c, h, w = x.shape
        y = group_norm(x, self.group_norm).to(dtype).reshape(n, c, h * w).transpose(1, 2)
        q, k, v = (_linear(y, lin, dtype) for lin in (self.to_q, self.to_k, self.to_v))
        attn = torch.einsum("nqc,nkc->nqk", q.float(), k.float())
        attn = torch.softmax(attn * (c ** -0.5), dim=-1).to(dtype)
        o = torch.einsum("nqk,nkc->nqc", attn.float(), v.float()).to(dtype)
        o = _linear(o, self.to_out[0], dtype)
        return x.to(dtype) + o.transpose(1, 2).reshape(n, c, h, w)


class Downsample(nn.Module):
    """Stride-2 conv with the SD VAE's asymmetric (0, 1, 0, 1) padding."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _conv(F.pad(x.to(dtype), (0, 1, 0, 1)), self.conv, dtype)


class Upsample(nn.Module):
    """Nearest 2x + conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _conv(F.interpolate(x, scale_factor=2, mode="nearest"), self.conv, dtype)


class _MidBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch), ResnetBlock(ch, ch)])
        self.attentions = nn.ModuleList([AttnBlock(ch)])

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = self.resnets[0](x, dtype)
        x = self.attentions[0](x, dtype)
        return self.resnets[1](x, dtype)


class _DownBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(in_ch if j == 0 else out_ch, out_ch) for j in range(layers))
        self.downsamplers = nn.ModuleList([Downsample(out_ch)]) if downsample else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for r in self.resnets:
            x = r(x, dtype)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x, dtype)
        return x


class _UpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(in_ch if j == 0 else out_ch, out_ch) for j in range(layers))
        self.upsamplers = nn.ModuleList([Upsample(out_ch)]) if upsample else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for r in self.resnets:
            x = r(x, dtype)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, dtype)
        return x


class Encoder(nn.Module):
    def __init__(self, block_out: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, in_ch: int = 3, latent_ch: int = 4):
        super().__init__()
        self.conv_in = nn.Conv2d(in_ch, block_out[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            _DownBlock(block_out[max(i - 1, 0)], ch, layers_per_block, i < len(block_out) - 1)
            for i, ch in enumerate(block_out))
        self.mid_block = _MidBlock(block_out[-1])
        self.conv_norm_out = nn.GroupNorm(32, block_out[-1], eps=_GN_EPS)
        self.conv_out = nn.Conv2d(block_out[-1], 2 * latent_ch, 3, padding=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x: NCHW images -> NCHW moments (mean ++ logvar), in ``dtype``."""
        h = _conv(x, self.conv_in, dtype)
        for down in self.down_blocks:
            h = down(h, dtype)
        h = self.mid_block(h, dtype)
        h = F.silu(group_norm(h, self.conv_norm_out).to(dtype))
        return _conv(h, self.conv_out, dtype)


class Decoder(nn.Module):
    def __init__(self, block_out: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 3, latent_ch: int = 4, out_ch: int = 3):
        super().__init__()
        rev = tuple(reversed(block_out))  # deepest level first
        self.conv_in = nn.Conv2d(latent_ch, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0])
        self.up_blocks = nn.ModuleList(
            _UpBlock(rev[max(i - 1, 0)], ch, layers_per_block, i < len(rev) - 1)
            for i, ch in enumerate(rev))
        self.conv_norm_out = nn.GroupNorm(32, rev[-1], eps=_GN_EPS)
        self.conv_out = nn.Conv2d(rev[-1], out_ch, 3, padding=1)

    def forward(self, z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """z: NCHW latents -> NCHW images, f32."""
        h = _conv(z, self.conv_in, dtype)
        h = self.mid_block(h, dtype)
        for up in self.up_blocks:
            h = up(h, dtype)
        h = F.silu(group_norm(h, self.conv_norm_out).to(dtype))
        return _conv(h, self.conv_out, dtype).float()


class AutoencoderKL(nn.Module):
    """The frozen first-stage model; f = 2^(len(block_out)-1). Parameters
    are f32 masters; ``dtype`` is the compute type."""

    def __init__(self, block_out: Tuple[int, ...] = (128, 256, 512, 512),
                 latent_ch: int = 4, out_ch: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block_out = tuple(block_out)
        self.dtype = dtype
        self.encoder = Encoder(block_out, 2, out_ch, latent_ch)
        self.decoder = Decoder(block_out, 3, latent_ch, out_ch)
        self.quant_conv = nn.Conv2d(2 * latent_ch, 2 * latent_ch, 1)
        self.post_quant_conv = nn.Conv2d(latent_ch, latent_ch, 1)

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (N, H, W, 3) in [-1, 1] -> (mean, logvar), each (N, H/8, W/8, 4)
        f32; logvar clipped to [-30, 20]."""
        with no_tf32():
            m = self.encoder(x.permute(0, 3, 1, 2), self.dtype)
            m = _conv(m, self.quant_conv, self.dtype).permute(0, 2, 3, 1)
        mean, logvar = m.chunk(2, dim=-1)
        return mean.float(), torch.clamp(logvar, -30.0, 20.0).float()

    def encode_sample(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A draw of the diagonal Gaussian (reference
        train_flow_latent.py:143): mean + exp(logvar / 2) * eps, with eps
        N(0, 1) from ``generator`` unless given."""
        mean, logvar = self.encode_moments(x)
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device)
        return mean + torch.exp(0.5 * logvar) * eps

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode_moments(x)[0]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: (N, h, w, 4) UNSCALED latents -> (N, 8h, 8w, 3), f32, in [-1, 1]-ish."""
        with no_tf32():
            x = z.permute(0, 3, 1, 2)
            x = _conv(x, self.post_quant_conv, self.dtype)
            img = self.decoder(x, self.dtype)
        return img.permute(0, 2, 3, 1).contiguous()


def create_vae(block_out: Tuple[int, ...] = (128, 256, 512, 512), *,
               dtype: torch.dtype = torch.float32, device: DeviceLike = None) -> AutoencoderKL:
    """The VAE on ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    with device:
        vae = AutoencoderKL(block_out, dtype=dtype)
    return vae.to(device)
