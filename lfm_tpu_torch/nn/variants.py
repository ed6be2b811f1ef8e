"""The model zoo's other networks (port of lfm_tpu/nn/variants.py; reference
models/guided_diffusion/unet.py:14-41, 658-879, unet_upsampler.py,
models/resnet.py:69-137):

* ``SuperResModel``: the ADM UNet over x and the bilinearly up-sampled
  low-resolution image, channel-concatenated (unet.py:658-672);
* ``EncoderUNetModel``: the UNet's encoder half as a classifier, pooled by
  ``adaptive``, ``attention`` (``AttentionPool2d``), ``spatial`` or
  ``spatial_v2`` heads (unet.py:675-879);
* ``UNetUpsamplerModel``: the super-resolution UNet with Gaussian Fourier
  embeddings of log t and log aug_level (``GaussianFourierProjection``,
  whose ``W`` is frozen: ``requires_grad=False``), returning the velocity,
  the trunk's features and the embedding (unet_upsampler.py:210-241);
* the CIFAR ResNet-18/34/50/101 with a softmax output, whose BatchNorm is
  flax's: batch statistics with the biased variance in train mode, running
  statistics updated with momentum 0.99 (torch's ``momentum=0.01``) and
  used in eval mode.

Names are the reference's: the UNets' ``time_embed``, ``input_blocks``,
``middle_block``, ``output_blocks`` and ``out`` as nn/adm_unet.py; the
classifier heads' ``out`` Sequential (``out.0`` norm and ``out.3`` 1x1
conv for ``adaptive``; ``out.2`` the AttentionPool2d with
``positional_embedding`` (C, T + 1), ``qkv_proj`` and ``c_proj`` as Conv1d;
``out.0`` / ``out.2`` Linear for ``spatial``; ``out.0``, ``out.1`` norm,
``out.3`` for ``spatial_v2``); the ResNet's ``conv1``, ``bn1``,
``layer{k}.{i}.{conv,bn}{1,2,3}``, ``.shortcut.{0,1}`` and ``linear``.
NHWC; dtypes as the JAX modules (the norms in f32). No hand-written kernel
runs here: the JAX package's variants reach no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lfm_tpu_torch.core.device import no_tf32
from lfm_tpu_torch.nn.adm_unet import (ADMAttentionBlock, ADMDownsample, ADMResBlock,
                                       UNetModel, build_unet_plan)
from lfm_tpu_torch.nn.convert_adm import adm_params_from_jax, layer_params_from_jax
from lfm_tpu_torch.nn.layers import GroupNorm32, conv_nhwc, dense, linear, timestep_embedding


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``jax.image.resize(x, (N, height, width, C), "bilinear")`` on NHWC x:
    per axis the triangle kernel at the half-pixel sample points, widened
    by the down-sampling factor (antialiasing), normalised over the input
    pixels it covers; computed in f32 as JAX computes its weights."""

    def weights(n_in: int, n_out: int) -> torch.Tensor:
        inv_scale = n_in / n_out
        sample = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) * inv_scale
        sample = sample - 0.5
        dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                               device=x.device)[:, None]).abs()
        w = torch.clamp(1.0 - dist / max(inv_scale, 1.0), min=0.0)
        total = w.sum(dim=0, keepdim=True)
        w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                        w / torch.where(total != 0, total, 1.0), 0.0)
        inside = (sample >= -0.5) & (sample <= n_in - 0.5)
        return torch.where(inside[None, :], w, 0.0)

    wh = weights(x.shape[1], height).to(x.dtype)
    ww = weights(x.shape[2], width).to(x.dtype)
    return torch.einsum("nhwc,hi,wj->nijc", x, wh, ww)


class SuperResModel(UNetModel):
    """The UNet over cat([x, up(low_res)]): build it with ``in_channels``
    already doubled (the reference doubles it itself, unet.py:665-666)."""

    def forward(self, t: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                low_res: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if low_res is None:
            raise ValueError("SuperResModel needs the low_res image")
        up = resize_bilinear(low_res, x.shape[1], x.shape[2])
        return super().forward(t, torch.cat([x, up], dim=-1), y, train, generator, context)


class AttentionPool2d(nn.Module):
    """CLIP's attention pooling (unet.py:14-41): the mean token first, a
    learned position embedding, one attention over the T + 1 tokens in
    (3, heads, d) order with the two-sided 1/sqrt(sqrt(d)) scale; the mean
    token's output through ``c_proj``."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads_channels: int,
                 output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.randn(embed_dim, spacial_dim ** 2 + 1) / embed_dim ** 0.5)
        self.qkv_proj = nn.Conv1d(embed_dim, 3 * embed_dim, 1)
        self.c_proj = nn.Conv1d(embed_dim, output_dim, 1)
        self.num_heads = embed_dim // num_heads_channels

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        n, h, w, c = x.shape
        tok = x.reshape(n, h * w, c)
        tok = torch.cat([tok.mean(dim=1, keepdim=True), tok], dim=1)
        tok = tok + self.positional_embedding.t()[None].to(tok.dtype)
        qkv = dense(tok, self.qkv_proj.weight[:, :, 0], self.qkv_proj.bias, dtype)
        heads = self.num_heads
        q, k, v = qkv.view(n, h * w + 1, 3, heads, c // heads).unbind(2)
        scale = 1.0 / math.sqrt(math.sqrt(c // heads))
        wgt = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", (q * scale).float(),
                                         (k * scale).float()), dim=-1)
        o = torch.einsum("nhqk,nkhd->nqhd", wgt, v.float()).reshape(n, h * w + 1, c)
        return dense(o, self.c_proj.weight[:, :, 0], self.c_proj.bias, dtype)[:, 0]


class EncoderUNetModel(nn.Module):
    """The half-UNet classifier (unet.py:675-879): (t, x) -> (N,
    out_channels) f32. ``image_size`` sets the attention pool's positions."""

    def __init__(self, image_size: int = 32, in_channels: int = 4, model_channels: int = 128,
                 out_channels: int = 1000, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (16, 8), dropout: float = 0.0,
                 channel_mult: Sequence[int] = (1, 2, 4, 8), num_heads: int = 1,
                 num_head_channels: int = -1, use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False, use_new_attention_order: bool = False,
                 pool: str = "adaptive", dtype: torch.dtype = torch.float32):
        super().__init__()
        if pool not in ("adaptive", "attention", "spatial", "spatial_v2"):
            raise NotImplementedError(pool)
        if pool == "attention" and num_head_channels == -1:
            raise ValueError("the attention pool needs num_head_channels")
        self.model_channels = model_channels
        self.pool = pool
        self.dtype = dtype
        ted = 4 * model_channels
        self.time_embed = nn.Sequential(nn.Linear(model_channels, ted), nn.SiLU(),
                                        nn.Linear(ted, ted))
        self.plan = plan = build_unet_plan(model_channels, channel_mult, num_res_blocks,
                                           attention_resolutions, in_channels, resblock_updown)
        res = dict(emb_ch=ted, dropout=dropout, use_scale_shift_norm=use_scale_shift_norm)

        def layer(spec):
            if spec.kind == "conv_in":
                return nn.Conv2d(spec.in_ch, spec.out_ch, 3, padding=1)
            if spec.kind in ("res", "res_down"):
                return ADMResBlock(spec.in_ch, spec.out_ch, down=spec.kind == "res_down", **res)
            if spec.kind == "attn":
                return ADMAttentionBlock(spec.out_ch, num_heads, num_head_channels,
                                         legacy_order=not use_new_attention_order)
            return ADMDownsample(spec.in_ch, spec.out_ch)

        self.input_blocks = nn.ModuleList(nn.ModuleList(layer(s) for s in block)
                                          for block in plan.input_blocks)
        self.middle_block = nn.ModuleList(layer(s) for s in plan.middle_block)
        ch = plan.middle_block[-1].out_ch
        if pool == "adaptive":
            self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), nn.AdaptiveAvgPool2d((1, 1)),
                                     nn.Conv2d(ch, out_channels, 1), nn.Flatten())
        elif pool == "attention":
            ds = 2 ** (len(channel_mult) - 1)
            self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), AttentionPool2d(
                image_size // ds, ch, num_head_channels, out_channels))
        else:
            feats = sum(block[-1].out_ch for block in plan.input_blocks) + ch
            if pool == "spatial":
                self.out = nn.Sequential(nn.Linear(feats, 2048), nn.ReLU(),
                                         nn.Linear(2048, out_channels))
            else:
                self.out = nn.Sequential(nn.Linear(feats, 2048), GroupNorm32(2048), nn.SiLU(),
                                         nn.Linear(2048, out_channels))

    def _run(self, layer, spec, h, emb, train, generator):
        if spec.kind in ("res", "res_down"):
            return layer(h, emb, self.dtype, train, generator)
        if spec.kind == "conv_in":
            return conv_nhwc(h, layer, self.dtype)
        return layer(h) if spec.kind == "attn" else layer(h, self.dtype)

    def forward(self, t: torch.Tensor, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n, dt = x.shape[0], self.dtype
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(n)
        with no_tf32():
            emb = timestep_embedding(t, self.model_channels).to(dt)
            emb = linear(F.silu(linear(emb, self.time_embed[0], dt)), self.time_embed[2], dt)
            h, feats = x.to(dt), []
            for layers, specs in zip(self.input_blocks, self.plan.input_blocks):
                for layer, spec in zip(layers, specs):
                    h = self._run(layer, spec, h, emb, train, generator)
                feats.append(h.mean(dim=(1, 2)))
            for layer, spec in zip(self.middle_block, self.plan.middle_block):
                h = self._run(layer, spec, h, emb, train, generator)
            out = self.out
            if self.pool == "adaptive":
                h = F.silu(out[0](h)).mean(dim=(1, 2))
                return dense(h, out[3].weight[:, :, 0, 0], out[3].bias, dt).float()
            if self.pool == "attention":
                return out[2](F.silu(out[0](h)), dt).float()
            feat = torch.cat([*feats, h.mean(dim=(1, 2))], dim=-1)
            if self.pool == "spatial":
                return linear(F.relu(linear(feat, out[0], dt)), out[2], dt).float()
            feat = linear(feat, out[0], dt)
            feat = F.silu(out[1](feat[:, None, None, :])[:, 0, 0])
            return linear(feat, out[3], dt).float()


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(dtype=f32)`` on NHWC x: in train mode the batch's
    mean and biased variance (E[x^2] - E[x]^2) in f32, which also move the
    running statistics with momentum 0.99; in eval mode the running
    statistics. Returns f32."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 1, 2))
            var = torch.clamp(xf.square().mean(dim=(0, 1, 2)) - mean.square(), min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype), None, conv.stride,
                    conv.padding).permute(0, 2, 3, 1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = FlaxBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = FlaxBatchNorm2d(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride, bias=False),
                                          FlaxBatchNorm2d(planes))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = F.relu(self.bn1(_conv(x, self.conv1, dtype)))
        h = self.bn2(_conv(h, self.conv2, dtype))
        if len(self.shortcut):
            x = self.shortcut[1](_conv(x, self.shortcut[0], dtype))
        return F.relu(x + h)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out = 4 * planes
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = FlaxBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FlaxBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = FlaxBatchNorm2d(out)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != out:
            self.shortcut = nn.Sequential(nn.Conv2d(in_planes, out, 1, stride, bias=False),
                                          FlaxBatchNorm2d(out))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = F.relu(self.bn1(_conv(x, self.conv1, dtype)))
        h = F.relu(self.bn2(_conv(h, self.conv2, dtype)))
        h = self.bn3(_conv(h, self.conv3, dtype))
        if len(self.shortcut):
            x = self.shortcut[1](_conv(x, self.shortcut[0], dtype))
        return F.relu(x + h)


class ResNet(nn.Module):
    """The CIFAR ResNet (models/resnet.py:69-137) on NHWC images: softmax
    probabilities (N, num_classes) in f32. ``train()`` mode normalises with
    the batch's statistics and moves the running ones."""

    def __init__(self, block=BasicBlock, num_blocks: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 10, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.bn1 = FlaxBatchNorm2d(64)
        in_planes = 64
        for k, nb in enumerate(num_blocks):
            planes, blocks = 64 * 2 ** k, []
            for i in range(nb):
                blocks.append(block(in_planes, planes, (2 if k else 1) if i == 0 else 1))
                in_planes = planes * block.expansion
            setattr(self, f"layer{k + 1}", nn.Sequential(*blocks))
        self.num_layers = len(num_blocks)
        self.linear = nn.Linear(in_planes, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        with no_tf32():
            h = F.relu(self.bn1(_conv(x, self.conv1, dt)))
            for k in range(self.num_layers):
                for blk in getattr(self, f"layer{k + 1}"):
                    h = blk(h, dt)
            logits = linear(h.mean(dim=(1, 2)), self.linear, dt)
        return torch.softmax(logits.float(), dim=-1)


def resnet18(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, **kw)


def resnet34(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), num_classes, **kw)


def resnet50(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, **kw)


def resnet101(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes, **kw)


class GaussianFourierProjection(nn.Module):
    """score_sde's fixed random features (unet_upsampler.py:62-64): [sin |
    cos] of 2 pi x W, W ~ N(0, scale^2) frozen (``requires_grad=False``)."""

    def __init__(self, embedding_size: int = 128, scale: float = 16.0):
        super().__init__()
        self.W = nn.Parameter(torch.randn(embedding_size) * scale, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xp = x[:, None] * self.W[None, :] * 2.0 * math.pi
        return torch.cat([torch.sin(xp), torch.cos(xp)], dim=-1)


class UNetUpsamplerModel(UNetModel):
    """The super-resolution UNet (unet_upsampler.py; dead code in the
    reference, ported for completeness as the JAX package did): the
    embedding Linear -> SiLU -> Linear over [GFP(log t) | GFP(log
    aug_level)], the conditioning signal bilinearly resized to
    ``image_size`` and concatenated with x (``in_channels`` counts both),
    the ADM trunk; returns (velocity f32, trunk features, embedding)."""

    def __init__(self, image_size: int = 64, in_channels: int = 6, model_channels: int = 128,
                 out_channels: int = 3, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (16, 8), dropout: float = 0.0,
                 channel_mult: Sequence[int] = (1, 2, 4, 8), conv_resample: bool = True,
                 num_classes: Optional[int] = None, num_heads: int = 1,
                 num_head_channels: int = -1, num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = False, resblock_updown: bool = False,
                 use_new_attention_order: bool = False, fourier_scale: float = 16.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(image_size, in_channels, model_channels, out_channels, num_res_blocks,
                         attention_resolutions, dropout, channel_mult, conv_resample,
                         num_classes, num_heads, num_head_channels, num_heads_upsample,
                         use_scale_shift_norm, resblock_updown, use_new_attention_order,
                         dtype=dtype)
        self.image_size = image_size
        self.in_channels = in_channels
        ted = 4 * model_channels
        self.time_embed[0] = nn.Linear(4 * model_channels, ted)
        self.aug_gfp = GaussianFourierProjection(model_channels, fourier_scale)
        self.time_gfp = GaussianFourierProjection(model_channels, fourier_scale)

    def forward(self, t: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                context: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        if context is None:
            raise ValueError("UNetUpsamplerModel's context is (cond_signal, aug_level)")
        cond, aug_level = context
        n, dt, plan = x.shape[0], self.dtype, self.plan
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(n)
        aug = torch.as_tensor(aug_level, dtype=torch.float32,
                              device=x.device).reshape(-1).expand(n)
        with no_tf32():
            emb = torch.cat([self.time_gfp(torch.log(t)), self.aug_gfp(torch.log(aug))],
                            dim=-1).to(dt)
            emb = linear(F.silu(linear(emb, self.time_embed[0], dt)), self.time_embed[2], dt)
            if self.num_classes is not None:
                if y is None:
                    raise ValueError("a class-conditional model needs y")
                emb = emb + self.label_emb.weight[y].to(dt)
            cond = resize_bilinear(cond, self.image_size, self.image_size)
            h = torch.cat([x, cond], dim=-1).to(dt)
            if h.shape[-1] != self.in_channels:
                raise ValueError(f"x and the resized conditioning have {h.shape[-1]} channels, "
                                 f"the model takes {self.in_channels}")
            hs = []
            for layers, specs in zip(self.input_blocks, plan.input_blocks):
                for layer, spec in zip(layers, specs):
                    h = self._run_layer(layer, spec, h, emb, train, generator, None)
                hs.append(h)
            for layer, spec in zip(self.middle_block, plan.middle_block):
                h = self._run_layer(layer, spec, h, emb, train, generator, None)
            for layers, specs in zip(self.output_blocks, plan.output_blocks):
                h = torch.cat([h, hs.pop()], dim=-1)
                for layer, spec in zip(layers, specs):
                    h = self._run_layer(layer, spec, h, emb, train, generator, None)
            out = conv_nhwc(F.silu(self.out[0](h)), self.out[2], dt)
        return out.float(), h, emb


# --- the JAX package's trees -> these modules' state_dicts ------------------

def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def upsampler_params_from_jax(flax_params: Mapping, plan) -> Dict[str, torch.Tensor]:
    """A flax ``UNetUpsamplerModel`` (or ``SuperResModel``) tree -> the
    port's ``state_dict``: the UNet's names, and the frozen ``W``s."""
    p = flax_params.get("params", flax_params)
    sd = adm_params_from_jax(p, plan)
    for name in ("aug_gfp", "time_gfp"):
        if name in p:
            sd[f"{name}.W"] = _t(p[name]["W"])
    return sd


def encoder_unet_params_from_jax(flax_params: Mapping, model: EncoderUNetModel
                                 ) -> Dict[str, torch.Tensor]:
    """A flax ``EncoderUNetModel`` tree -> the port's ``state_dict``."""
    p = flax_params.get("params", flax_params)
    sd: Dict[str, torch.Tensor] = {}
    for name, i in (("time_embed_1", 0), ("time_embed_2", 2)):
        sd[f"time_embed.{i}.weight"] = _t(np.asarray(p[name]["kernel"]).T)
        sd[f"time_embed.{i}.bias"] = _t(p[name]["bias"])
    for i, block in enumerate(model.plan.input_blocks):
        for j, spec in enumerate(block):
            layer_params_from_jax(sd, f"input_blocks.{i}.{j}", spec, p[f"input_{i}_{j}"])
    for j, spec in enumerate(model.plan.middle_block):
        layer_params_from_jax(sd, f"middle_block.{j}", spec, p[f"middle_{j}"])

    def lin(key, q, conv=0):
        w = np.asarray(q["kernel"]).T
        sd[f"{key}.weight"] = _t(w.reshape(w.shape + (1,) * conv))
        sd[f"{key}.bias"] = _t(q["bias"])

    def gn(key, q):
        sd[f"{key}.weight"] = _t(q["norm"]["scale"])
        sd[f"{key}.bias"] = _t(q["norm"]["bias"])

    if model.pool == "adaptive":
        gn("out.0", p["out_norm"])
        lin("out.3", p["out_proj"], conv=2)
    elif model.pool == "attention":
        gn("out.0", p["out_norm"])
        pool = p["out_pool"]
        sd["out.2.positional_embedding"] = _t(np.asarray(pool["positional_embedding"]).T)
        lin("out.2.qkv_proj", pool["qkv_proj"], conv=1)
        lin("out.2.c_proj", pool["c_proj"], conv=1)
    else:
        lin("out.0", p["fc1"])
        if model.pool == "spatial_v2":
            gn("out.1", p["fc_norm"])
        lin(f"out.{2 if model.pool == 'spatial' else 3}", p["fc2"])
    return sd


def resnet_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ResNet's ``{"params", "batch_stats"}`` -> the port's
    ``state_dict`` (running statistics included; ``num_batches_tracked``
    is 0)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def torch_name(flax_name: str) -> str:
        names = {"shortcut": "shortcut.0", "bn_sc": "shortcut.1"}
        parts = []
        for part in flax_name.split("/"):
            if part.startswith("layer"):
                layer, idx = part.split("_")
                parts += [layer, idx]
            else:
                parts.append(names.get(part, part))
        return ".".join(parts)

    def walk(tree, path=()):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                yield from walk(value, path + (key,))
            else:
                yield "/".join(path), key, np.asarray(value)

    for module, leaf, a in walk(params):
        key = torch_name(module)
        if leaf == "kernel" and a.ndim == 4:
            sd[f"{key}.weight"] = _t(a.transpose(3, 2, 0, 1))
        elif leaf == "kernel":
            sd[f"{key}.weight"] = _t(a.T)
        else:
            sd[f"{key}.{'weight' if leaf == 'scale' else 'bias'}"] = _t(a)
    for module, leaf, a in walk(stats):
        key = torch_name(module)
        sd[f"{key}.running_{'mean' if leaf == 'mean' else 'var'}"] = _t(a)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)
    return sd
