"""EDM's DhariwalUNet velocity network (port of the DhariwalUNet half of
lfm_tpu/nn/edm_unet.py; reference models/EDM.py:63-292, 490-522, 716-861).

ffhq_adm, bed_adm and imnet_adm (``model_type="adm"`` without
``use_origin_adm``) build this network. Activations are NHWC, as in the
JAX package.

Module and parameter names are the reference's, so a released
``model_{E}.pth`` loads with ``load_state_dict``: ``map_layer0``,
``map_layer1``, ``map_label`` (no bias), ``enc.{res}x{res}_conv``,
``enc.{res}x{res}_down``, ``enc.{res}x{res}_block{i}``,
``dec.{res}x{res}_in{0,1}``, ``dec.{res}x{res}_up``,
``dec.{res}x{res}_block{i}``, ``out_norm``, ``out_conv``; in a block
``norm0``, ``conv0``, ``affine``, ``norm1``, ``conv1``, ``skip``, and with
attention ``norm2``, ``qkv`` and ``proj`` as 1x1 convolutions. A resampling
convolution holds the reference's ``resample_filter`` buffer.

Dtypes follow the JAX module: convolutions and Dense layers in ``dtype``
with the product and the bias rounded apart (``layers.dense``); GroupNorm
in f32 with ``min(32, C // 4)`` groups, cast back; the attention's qkv,
scores, softmax and proj in f32 whatever ``dtype``, with the (head, ch, 3)
qkv layout and k scaled by 1/sqrt(d) before the product. TF32 is off within
``forward``, so an f32 network is f32 on the card. No hand-written kernel
runs here: the JAX module's attention is an einsum and its GroupNorm
flax's, neither a Pallas kernel.

The class label enters as a one-hot row, and a label outside
``[0, label_dim)``, such as CFG's null label -1, gives the zero row, as
``jax.nn.one_hot`` does (the reference's drop_half_label zeroing,
EDM.py:825-826). DhariwalUNet's block settings are fixed here (adaptive
scale-shift, skip_scale 1, the [1, 1] resampling filter, eps 1e-5);
SongUNet and the context variant are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lfm_tpu_torch.core.config import ModelConfig
from lfm_tpu_torch.core.device import DeviceLike, no_tf32, resolve_device
from lfm_tpu_torch.nn.layers import conv2d_nhwc, dense, dropout, group_norm_f32, linear


# DhariwalUNet's resampling filter (EDM.py:725)
RESAMPLE_FILTER = (1.0, 1.0)


def resample_kernel() -> torch.Tensor:
    """The reference's ``resample_filter`` buffer: outer(f, f) / sum(f)^2,
    shape (1, 1, k, k)."""
    f = torch.as_tensor(RESAMPLE_FILTER, dtype=torch.float32)
    return (torch.outer(f, f) / f.sum().square())[None, None]


def depthwise_down(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """conv2d with the (1, 1, k, k) filter on every channel, stride 2, on
    NHWC x (EDM.py:124-127)."""
    c = x.shape[-1]
    w = kernel.to(x.dtype).tile(c, 1, 1, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=2, padding=(kernel.shape[-1] - 1) // 2,
                 groups=c)
    return y.permute(0, 2, 3, 1)


def depthwise_up(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """conv_transpose2d with 4x the filter on every channel, stride 2, on
    NHWC x (EDM.py:120-123)."""
    c = x.shape[-1]
    w = (kernel * 4).to(x.dtype).tile(c, 1, 1, 1)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=2,
                           padding=(kernel.shape[-1] - 1) // 2, groups=c)
    return y.permute(0, 2, 3, 1)


def positional_embedding(t: torch.Tensor, num_channels: int) -> torch.Tensor:
    """[cos | sin] of t times 10000^(-i / half), without the endpoint (EDM
    PositionalEmbedding, EDM.py:490-509). t: (N,); returns (N, num_channels)
    f32."""
    half = num_channels // 2
    freqs = torch.arange(half, dtype=torch.float32, device=t.device) / half
    freqs = (1.0 / 10_000.0) ** freqs
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=1)


class EDMConv(nn.Module):
    """The reference's Conv2d without fused resampling (EDM.py:63-132): an
    optional 2x up or down resample, then a kxk convolution; ``kernel=0``
    resamples only and has no weights. ``init_scale=0`` starts the weight
    at zero, as the JAX module's zero-initialised layers."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, up: bool = False,
                 down: bool = False, init_scale: float = 1.0):
        super().__init__()
        self.out_channels = out_channels
        self.up, self.down = up, down
        self.weight = self.bias = None
        if kernel:
            fan_in = in_channels * kernel * kernel
            self.weight = nn.Parameter(
                torch.randn(out_channels, in_channels, kernel, kernel) * init_scale
                / math.sqrt(fan_in))
            self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("resample_filter", resample_kernel() if up or down else None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype)
        if self.up:
            x = depthwise_up(x, self.resample_filter)
        if self.down:
            x = depthwise_down(x, self.resample_filter)
        if self.weight is None:
            return x
        return conv2d_nhwc(x, self.weight, self.bias, dtype, padding=self.weight.shape[-1] // 2)

    def as_dense(self) -> torch.Tensor:
        """A 1x1 convolution's weight as a (out, in) matrix."""
        return self.weight[:, :, 0, 0]


class EDMGroupNorm(nn.GroupNorm):
    """GroupNorm of min(32, C // 4) groups, eps 1e-5 (EDM.py:139-151),
    computed in f32 on NHWC x and cast back to x's type."""

    def __init__(self, num_channels: int):
        super().__init__(min(32, num_channels // 4), num_channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_f32(x, self).to(x.dtype)


class EDMUNetBlock(nn.Module):
    """The reference's UNetBlock (EDM.py:188-292) with DhariwalUNet's
    settings: GroupNorm, SiLU, conv; the embedding's scale and shift around
    the second GroupNorm; SiLU, dropout, a zero-initialised conv; the skip
    (a 1x1 conv where the width changes, else a bare resample where the
    block resamples); then, with ``attention``, f32 self-attention with
    64 channels a head."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 up: bool = False, down: bool = False, attention: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.out_channels = out_channels
        self.num_heads = out_channels // 64 if attention else 0
        self.dropout = dropout
        self.norm0 = EDMGroupNorm(in_channels)
        self.conv0 = EDMConv(in_channels, out_channels, 3, up=up, down=down)
        self.affine = nn.Linear(emb_channels, 2 * out_channels)
        self.norm1 = EDMGroupNorm(out_channels)
        self.conv1 = EDMConv(out_channels, out_channels, 3, init_scale=0.0)
        self.skip = None
        if out_channels != in_channels or up or down:
            kernel = 1 if out_channels != in_channels else 0
            self.skip = EDMConv(in_channels, out_channels, kernel, up=up, down=down)
        if self.num_heads:
            self.norm2 = EDMGroupNorm(out_channels)
            self.qkv = EDMConv(out_channels, 3 * out_channels, 1)
            self.proj = EDMConv(out_channels, out_channels, 1, init_scale=0.0)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, dtype: torch.dtype,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = self.conv0(F.silu(self.norm0(x)), dtype)
        scale, shift = linear(emb, self.affine, dtype).chunk(2, dim=-1)
        h = F.silu(shift[:, None, None, :] + self.norm1(h) * (scale[:, None, None, :] + 1.0))
        if train:
            h = dropout(h, self.dropout, generator)
        h = self.conv1(h, dtype)
        x = h + (x if self.skip is None else self.skip(x, dtype))
        if not self.num_heads:
            return x
        n, hh, ww, c = x.shape
        t, heads = hh * ww, self.num_heads
        hd = c // heads
        y = self.norm2(x).reshape(n, t, c)
        qkv = dense(y, self.qkv.as_dense(), self.qkv.bias, torch.float32)
        # the reference's layout: a channel index is (head, ch, 3)
        # (EDM.py:277-281)
        q, k, v = qkv.view(n, t, heads, hd, 3).unbind(-1)
        w = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q, k / math.sqrt(hd)), dim=-1)
        a = torch.einsum("nhqk,nkhd->nqhd", w, v).reshape(n, t, c)
        a = dense(a, self.proj.as_dense(), self.proj.bias, torch.float32)
        return x + a.reshape(n, hh, ww, c).to(x.dtype)


class DhariwalUNet(nn.Module):
    """Velocity network v(t, x, y) (EDM.py:716-861); x: (N, H, W, C) NHWC
    latents. Parameters are f32 masters; ``dtype`` is the compute type."""

    def __init__(self, img_resolution: int, in_channels: int = 4, out_channels: int = 4,
                 label_dim: int = 0, model_channels: int = 192,
                 channel_mult: Sequence[int] = (1, 2, 3, 4), num_blocks: int = 3,
                 attn_resolutions: Sequence[int] = (32, 16, 8), dropout: float = 0.10,
                 label_dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model_channels = model_channels
        self.label_dim = label_dim
        self.label_dropout = label_dropout
        self.dtype = dtype
        emb_ch = 4 * model_channels
        block = dict(emb_channels=emb_ch, dropout=dropout)
        self.map_layer0 = nn.Linear(model_channels, emb_ch)
        self.map_layer1 = nn.Linear(emb_ch, emb_ch)
        self.map_label = nn.Linear(label_dim, emb_ch, bias=False) if label_dim else None

        self.enc = nn.ModuleDict()
        cout = in_channels
        for level, mult in enumerate(channel_mult):
            res = img_resolution >> level
            if level == 0:
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_conv"] = EDMConv(cin, cout, 3)
            else:
                self.enc[f"{res}x{res}_down"] = EDMUNetBlock(cout, cout, down=True, **block)
            for idx in range(num_blocks):
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_block{idx}"] = EDMUNetBlock(
                    cin, cout, attention=res in attn_resolutions, **block)
        skips = [b.out_channels for b in self.enc.values()]

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
                    cin, cout, attention=res in attn_resolutions, **block)
        self.out_norm = EDMGroupNorm(cout)
        self.out_conv = EDMConv(cout, out_channels, 3, init_scale=0.0)

    @property
    def null_label(self) -> int:
        """CFG's null label: one_hot(-1) is the zero row, the reference's
        drop_half_label zeroing (EDM.py:825-826)."""
        return -1

    def forward(self, t: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                train: bool = False, drop_half_label: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """v(t, x, y) in f32. ``train`` turns dropout and label dropout on,
        their masks drawn from ``generator`` (the label mask first, then the
        blocks' in order); ``drop_half_label`` zeroes the second half's
        labels (CFG on a doubled batch)."""
        n = x.shape[0]
        dt = self.dtype
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(n)
        with no_tf32():
            emb = positional_embedding(t, self.model_channels)
            emb = F.silu(linear(emb, self.map_layer0, dt))
            emb = linear(emb, self.map_layer1, dt)
            if self.map_label is not None and y is not None:
                classes = torch.arange(self.label_dim, device=x.device)
                onehot = (y.reshape(-1, 1) == classes).float()
                if train and self.label_dropout > 0:
                    keep = torch.rand((n, 1), generator=generator,
                                      device=x.device) >= self.label_dropout
                    onehot = onehot * keep
                elif drop_half_label:
                    onehot = onehot * (torch.arange(n, device=x.device) < n // 2)[:, None]
                emb = emb + dense(onehot, self.map_label.weight, None, dt)
            emb = F.silu(emb)

            h = x.to(dt)
            skips = []
            for name, layer in self.enc.items():
                h = (layer(h, dt) if name.endswith("_conv")
                     else layer(h, emb, dt, train, generator))
                skips.append(h)
            for name, layer in self.dec.items():
                if "_block" in name:
                    h = torch.cat([h, skips.pop()], dim=-1)
                h = layer(h, emb, dt, train, generator)
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


def create_edm_network(cfg: ModelConfig, *, dtype: torch.dtype = torch.float32,
                       device: DeviceLike = None) -> DhariwalUNet:
    """Factory for EDM's networks (reference models/EDM.py:864-939), built on
    ``device`` (the card unless ``device="cpu"``): ``adm`` is DhariwalUNet;
    ``ncsn++``, ``ddpm++`` (SongUNet) and ``adm_context`` raise."""
    if cfg.model_type in ("ncsn++", "ddpm++", "adm_context"):
        raise NotImplementedError(
            f"model_type {cfg.model_type!r} (EDM's SongUNet or context DhariwalUNet) is not "
            "ported yet (ROADMAP Queue 1 item 6)")
    if cfg.model_type != "adm":
        raise ValueError(f"unknown EDM model_type {cfg.model_type!r}")
    device = resolve_device(device)
    with device:
        model = DhariwalUNet(
            img_resolution=cfg.latent_size,
            in_channels=cfg.num_in_channels,
            out_channels=cfg.num_out_channels,
            label_dim=cfg.label_dim,
            model_channels=cfg.nf,
            channel_mult=tuple(cfg.ch_mult),
            num_blocks=cfg.num_res_blocks,
            attn_resolutions=tuple(cfg.attn_resolutions),
            dropout=cfg.dropout,
            label_dropout=cfg.label_dropout,
            dtype=dtype,
        )
    return model.to(device)
