"""ADM ("guided diffusion") UNet velocity network (port of
lfm_tpu/nn/adm_unet.py).

The reference's vendored OpenAI UNet (reference
models/guided_diffusion/unet.py:376-655), with every flag the released
origin-ADM checkpoints use: scale-shift GroupNorm conditioning, resblock
up/down-sampling, legacy vs new qkv order, attention at
``attention_resolutions``, class conditioning, conv or average-pool
resampling. Activations are NHWC, as in the JAX package.

Module and parameter names are the reference's (``time_embed.{0,2}``,
``label_emb``, ``input_blocks.{i}.{j}``, ``middle_block.{j}``,
``output_blocks.{i}.{j}``, ``out.{0,2}``; ResBlock ``in_layers.{0,2}``,
``emb_layers.1``, ``out_layers.{0,3}``, ``skip_connection``; attention
``norm``, ``qkv``, ``proj_out`` as Conv1d (O, I, 1); resampling ``op`` and
``conv``), so a released ``model_{E}.pth`` loads with ``load_state_dict``.
``build_unet_plan`` gives which layer sits at which index.

Dtypes follow the JAX module: convolutions and Dense layers in ``dtype``
with the product and the bias rounded apart (``layers.conv_nhwc``,
``layers.dense``); GroupNorm in f32, cast back; attention an f32 island.
With ``use_flash`` attention goes through ``fused_attention`` (K1 on a
CUDA tensor, K4 past T = 1024) with the single 1/sqrt(d) scale, otherwise
the reference's two-sided 1/sqrt(sqrt(d)) einsum. With ``use_fused_gn`` the
ResBlocks' GroupNorm + SiLU go through ``FusedGNSiLU`` (K6 on a CUDA
tensor). TF32 is off within ``forward``, so an f32 UNet is f32 on the card.
The SpatialTransformer layout variant is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lfm_tpu_torch.core.config import ModelConfig
from lfm_tpu_torch.core.device import DeviceLike, no_tf32, resolve_device
from lfm_tpu_torch.kernels.flash_attention import fused_attention, fused_attention_qkv
from lfm_tpu_torch.kernels.groupnorm_silu import FusedGNSiLU
from lfm_tpu_torch.nn.layers import (GroupNorm32, conv_nhwc, dense, group_norm_f32, linear,
                                     timestep_embedding)


# ---------------------------------------------------------------------------
# Topology plan (mirrors unet.py:463-595 block construction)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str  # conv_in | res | attn | down | up | res_down | res_up
    in_ch: int = 0
    out_ch: int = 0


@dataclasses.dataclass(frozen=True)
class UNetPlan:
    input_blocks: Tuple[Tuple[LayerSpec, ...], ...]
    middle_block: Tuple[LayerSpec, ...]
    output_blocks: Tuple[Tuple[LayerSpec, ...], ...]
    out_ch_final: int


def build_unet_plan(
    model_channels: int,
    channel_mult: Sequence[int],
    num_res_blocks: int,
    attention_resolutions: Sequence[int],
    in_channels: int,
    resblock_updown: bool,
) -> UNetPlan:
    ch = int(channel_mult[0] * model_channels)
    inputs: List[Tuple[LayerSpec, ...]] = [(LayerSpec("conv_in", in_channels, ch),)]
    chans = [ch]
    ds = 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            layers = [LayerSpec("res", ch, int(mult * model_channels))]
            ch = int(mult * model_channels)
            if ds in attention_resolutions:
                layers.append(LayerSpec("attn", ch, ch))
            inputs.append(tuple(layers))
            chans.append(ch)
        if level != len(channel_mult) - 1:
            kind = "res_down" if resblock_updown else "down"
            inputs.append((LayerSpec(kind, ch, ch),))
            chans.append(ch)
            ds *= 2

    middle = (
        LayerSpec("res", ch, ch),
        LayerSpec("attn", ch, ch),
        LayerSpec("res", ch, ch),
    )

    outputs: List[Tuple[LayerSpec, ...]] = []
    for level, mult in list(enumerate(channel_mult))[::-1]:
        for i in range(num_res_blocks + 1):
            ich = chans.pop()
            layers = [LayerSpec("res", ch + ich, int(model_channels * mult))]
            ch = int(model_channels * mult)
            if ds in attention_resolutions:
                layers.append(LayerSpec("attn", ch, ch))
            if level and i == num_res_blocks:
                kind = "res_up" if resblock_updown else "up"
                layers.append(LayerSpec(kind, ch, ch))
                ds //= 2
            outputs.append(tuple(layers))

    return UNetPlan(tuple(inputs), middle, tuple(outputs), ch)


def plan_layers(plan: UNetPlan):
    """Every layer of the plan in forward order."""
    for block in plan.input_blocks:
        yield from block
    yield from plan.middle_block
    for block in plan.output_blocks:
        yield from block


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _upsample(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x on NHWC (``jax.image.resize(..., "nearest")``)."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, on NHWC (flax ``avg_pool``)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class ADMUpsample(nn.Module):
    def __init__(self, channels: int, out_ch: int, use_conv: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_ch, 3, padding=1) if use_conv else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = _upsample(x)
        return x if self.conv is None else conv_nhwc(x, self.conv, dtype)


class ADMDownsample(nn.Module):
    def __init__(self, channels: int, out_ch: int, use_conv: bool = True):
        super().__init__()
        self.op = nn.Conv2d(channels, out_ch, 3, stride=2, padding=1) if use_conv else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _avg_pool(x) if self.op is None else conv_nhwc(x, self.op, dtype)


class _GNSiLU(GroupNorm32):
    """GroupNorm32 + SiLU in one module (its parameters are the norm's):
    f32 statistics and SiLU, cast back to x's type; with ``fused`` through
    ``FusedGNSiLU`` (K6 on a CUDA tensor), which gives the same values."""

    def __init__(self, channels: int, fused: bool = False):
        super().__init__(channels)
        self.fused = fused

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return FusedGNSiLU.apply(x.contiguous(), self.weight, self.bias, self.num_groups,
                                     self.eps)
        return F.silu(group_norm_f32(x, self)).to(x.dtype)


class ADMResBlock(nn.Module):
    """ResBlock with optional scale-shift norm and up/down resampling
    (reference unet.py:131-238). ``in_layers`` and ``out_layers`` keep the
    reference's Sequential indices (norm 0, conv 2 or 3) for the
    ``state_dict`` names; ``forward`` calls their members, with the SiLU
    after a norm inside ``_GNSiLU``."""

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int, dropout: float = 0.0,
                 use_scale_shift_norm: bool = True, up: bool = False, down: bool = False,
                 fused_gn: bool = False):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down, self.dropout = up, down, dropout
        self.in_layers = nn.Sequential(_GNSiLU(in_ch, fused_gn), nn.SiLU(),
                                       nn.Conv2d(in_ch, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_ch, 2 * out_ch if use_scale_shift_norm else out_ch))
        out_norm = GroupNorm32(out_ch) if use_scale_shift_norm else _GNSiLU(out_ch, fused_gn)
        self.out_layers = nn.Sequential(out_norm, nn.SiLU(), nn.Dropout(dropout),
                                        nn.Conv2d(out_ch, out_ch, 3, padding=1))
        self.skip_connection = nn.Conv2d(in_ch, out_ch, 1) if out_ch != in_ch else nn.Identity()

    def forward(self, x: torch.Tensor, emb: torch.Tensor, dtype: torch.dtype,
                train: bool = False) -> torch.Tensor:
        h = self.in_layers[0](x)
        if self.up or self.down:
            resample = _upsample if self.up else _avg_pool
            h, x = resample(h), resample(x)
        h = conv_nhwc(h, self.in_layers[2], dtype)
        e = linear(F.silu(emb), self.emb_layers[1], dtype)
        if self.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=-1)
            h = self.out_layers[0](h) * (1.0 + scale[:, None, None, :]) + shift[:, None, None, :]
            h = F.silu(h)
        else:
            h = self.out_layers[0](h + e[:, None, None, :])
        h = F.dropout(h, self.dropout, training=train)
        h = conv_nhwc(h, self.out_layers[3], dtype)
        if isinstance(self.skip_connection, nn.Conv2d):
            x = conv_nhwc(x, self.skip_connection, dtype)
        return x + h


class ADMAttentionBlock(nn.Module):
    """Spatial self-attention over H*W tokens (reference unet.py:241-287),
    in f32. ``legacy_order`` selects the qkv channel layout: (heads, 3, hd)
    (QKVAttentionLegacy, unet.py:310-334) or (3, heads, hd) (QKVAttention,
    unet.py:341-369)."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1,
                 legacy_order: bool = True, use_flash: bool = False):
        super().__init__()
        self.num_heads = (channels // num_head_channels if num_head_channels != -1
                          else num_heads)
        self.legacy_order = legacy_order
        self.use_flash = use_flash
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        heads, t = self.num_heads, h * w
        hd = c // heads
        y = group_norm_f32(x, self.norm).reshape(n, t, c)
        qkv = dense(y, self.qkv.weight[:, :, 0], self.qkv.bias, torch.float32)
        if self.use_flash and not self.legacy_order:
            # (3, heads, hd): the fused qkv row the kernels read in place
            o = fused_attention_qkv(qkv, heads)
        else:
            if self.legacy_order:
                q, k, v = qkv.view(n, t, heads, 3, hd).unbind(3)
            else:
                q, k, v = qkv.view(n, t, 3, heads, hd).unbind(2)
            if self.use_flash:
                # the single 1/sqrt(hd) logit scale equals the reference's
                # two-sided 1/sqrt(sqrt(hd)) (unet.py:325-330)
                o = fused_attention(q, k, v)
            else:
                scale = 1.0 / math.sqrt(math.sqrt(hd))
                attn = torch.einsum("nqhd,nkhd->nhqk", q * scale, k * scale)
                o = torch.einsum("nhqk,nkhd->nqhd", torch.softmax(attn, dim=-1), v)
        o = dense(o.reshape(n, t, c), self.proj_out.weight[:, :, 0], self.proj_out.bias,
                  torch.float32)
        return x + o.reshape(n, h, w, c).to(x.dtype)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class UNetModel(nn.Module):
    """Velocity network v(t, x, y); x: (N, H, W, C) NHWC latents. Parameters
    are f32 masters; ``dtype`` is the compute type. ``image_size`` is the
    JAX module's field, which the forward does not read either."""

    def __init__(self, image_size: int = 32, in_channels: int = 4, model_channels: int = 256,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (16, 8), dropout: float = 0.0,
                 channel_mult: Sequence[int] = (1, 2, 2, 2), conv_resample: bool = True,
                 num_classes: Optional[int] = None, num_heads: int = 4,
                 num_head_channels: int = -1, num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = True, resblock_updown: bool = False,
                 use_new_attention_order: bool = False, use_fused_gn: bool = False,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False):
        super().__init__()
        self.model_channels = model_channels
        self.num_classes = num_classes
        self.dtype = dtype
        self.use_flash = use_flash
        self.plan = build_unet_plan(model_channels, channel_mult, num_res_blocks,
                                    attention_resolutions, in_channels, resblock_updown)
        ted = 4 * model_channels
        self.time_embed = nn.Sequential(nn.Linear(model_channels, ted), nn.SiLU(),
                                        nn.Linear(ted, ted))
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, ted)

        def layer(spec: LayerSpec, upsample_heads: bool = False) -> nn.Module:
            heads = (num_heads_upsample if upsample_heads and num_heads_upsample != -1
                     else num_heads)
            res = dict(emb_ch=ted, dropout=dropout, use_scale_shift_norm=use_scale_shift_norm,
                       fused_gn=use_fused_gn)
            if spec.kind == "conv_in":
                return nn.Conv2d(spec.in_ch, spec.out_ch, 3, padding=1)
            if spec.kind in ("res", "res_down", "res_up"):
                return ADMResBlock(spec.in_ch, spec.out_ch, down=spec.kind == "res_down",
                                   up=spec.kind == "res_up", **res)
            if spec.kind == "attn":
                return ADMAttentionBlock(spec.out_ch, heads, num_head_channels,
                                         legacy_order=not use_new_attention_order,
                                         use_flash=use_flash)
            if spec.kind == "down":
                return ADMDownsample(spec.in_ch, spec.out_ch, conv_resample)
            if spec.kind == "up":
                return ADMUpsample(spec.in_ch, spec.out_ch, conv_resample)
            raise ValueError(spec.kind)

        plan = self.plan
        self.input_blocks = nn.ModuleList(
            nn.ModuleList(layer(s) for s in block) for block in plan.input_blocks)
        self.middle_block = nn.ModuleList(layer(s) for s in plan.middle_block)
        self.output_blocks = nn.ModuleList(
            nn.ModuleList(layer(s, upsample_heads=True) for s in block)
            for block in plan.output_blocks)
        ch = plan.out_ch_final
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                 nn.Conv2d(ch, out_channels, 3, padding=1))

    @property
    def null_label(self) -> int:
        """CFG null class: origin ADM embeds labels by a gather (reference
        unet.py:630), so -1 would wrap to the last class; the reference
        harness uses class 0 (test_flow_latent.py:180)."""
        return 0

    def _run_layer(self, layer: nn.Module, spec: LayerSpec, h: torch.Tensor, emb: torch.Tensor,
               train: bool) -> torch.Tensor:
        if spec.kind in ("res", "res_down", "res_up"):
            return layer(h, emb, self.dtype, train)
        if spec.kind == "conv_in":
            return conv_nhwc(h, layer, self.dtype)
        if spec.kind == "attn":
            return layer(h)
        return layer(h, self.dtype)

    def forward(self, t: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        """v(t, x, y) in f32; ``train`` turns dropout on."""
        n = x.shape[0]
        dt = self.dtype
        plan = self.plan
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(n)
        with no_tf32():
            emb = timestep_embedding(t, self.model_channels).to(dt)
            emb = linear(emb, self.time_embed[0], dt)
            emb = linear(F.silu(emb), self.time_embed[2], dt)
            if self.num_classes is not None:
                if y is None:
                    raise ValueError("a class-conditional model needs y")
                emb = emb + self.label_emb.weight[y].to(dt)

            h = x.to(dt)
            hs = []
            for layers, specs in zip(self.input_blocks, plan.input_blocks):
                for layer, spec in zip(layers, specs):
                    h = self._run_layer(layer, spec, h, emb, train)
                hs.append(h)
            for layer, spec in zip(self.middle_block, plan.middle_block):
                h = self._run_layer(layer, spec, h, emb, train)
            for layers, specs in zip(self.output_blocks, plan.output_blocks):
                h = torch.cat([h, hs.pop()], dim=-1)
                for layer, spec in zip(layers, specs):
                    h = self._run_layer(layer, spec, h, emb, train)
            h = F.silu(self.out[0](h))
            h = conv_nhwc(h, self.out[2], dt)
        return h.float()


def create_adm_unet(cfg: ModelConfig, *, dtype: torch.dtype = torch.float32,
                    use_flash: bool = False, use_fused_gn: bool = False,
                    device: DeviceLike = None) -> UNetModel:
    """Factory for ``use_origin_adm`` (reference models/__init__.py:47-68),
    built on ``device`` (the card unless ``device="cpu"``)."""
    if cfg.layout:
        raise NotImplementedError("the SpatialTransformer layout variant of the ADM UNet "
                                  "is not ported yet")
    device = resolve_device(device)
    with device:
        model = UNetModel(
            image_size=cfg.latent_size,
            in_channels=cfg.num_in_channels,
            model_channels=cfg.nf,
            out_channels=cfg.num_out_channels,
            num_res_blocks=cfg.num_res_blocks,
            attention_resolutions=tuple(cfg.attn_resolutions),
            dropout=cfg.dropout,
            channel_mult=tuple(cfg.ch_mult),
            conv_resample=cfg.resamp_with_conv,
            num_classes=cfg.num_classes if (cfg.num_classes or 0) > 1 else None,
            num_heads=cfg.num_heads,
            num_head_channels=cfg.num_head_channels,
            num_heads_upsample=cfg.num_head_upsample,
            use_scale_shift_norm=cfg.use_scale_shift_norm,
            resblock_updown=cfg.resblock_updown,
            use_new_attention_order=cfg.use_new_attention_order,
            use_fused_gn=use_fused_gn,
            dtype=dtype,
            use_flash=use_flash,
        )
    return model.to(device)
