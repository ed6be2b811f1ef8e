"""State dicts for this package's AutoencoderKL (diffusers key names).

``vae_params_from_jax``: the inverse of lfm_tpu/vae/convert.py. Input: a
flax param tree (``{"params": ...}`` or the inner dict) as numpy arrays.
Layouts: conv HWIO -> OIHW; attention Dense (in, out) -> Linear (out, in);
``quant_conv`` / ``post_quant_conv`` Dense (c, c) -> 1x1 conv (c, c, 1, 1);
GroupNorm scale/bias -> weight/bias.

``load_vae_state_dict``: a diffusers AutoencoderKL checkpoint (``.bin`` /
``.pth`` through ``torch.load``, or ``.safetensors``) in either attention
naming, the current ``to_q/to_k/to_v/to_out.0`` or the 2022
``query/key/value/proj_attn``, whose 1x1-conv attention weights are
squeezed to Linear weights (lfm_tpu/vae/convert.py:52-62,119-128).
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _conv(sd: Dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{name}.bias"] = _t(p["bias"])


def _gn(sd: Dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _dense(sd: Dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{name}.bias"] = _t(p["bias"])


def _resnet(sd: Dict, pfx: str, p: Mapping) -> None:
    _gn(sd, f"{pfx}.norm1", p["norm1"])
    _conv(sd, f"{pfx}.conv1", p["conv1"])
    _gn(sd, f"{pfx}.norm2", p["norm2"])
    _conv(sd, f"{pfx}.conv2", p["conv2"])
    if "conv_shortcut" in p:
        _conv(sd, f"{pfx}.conv_shortcut", p["conv_shortcut"])


def _mid(sd: Dict, pfx: str, p: Mapping) -> None:
    _resnet(sd, f"{pfx}.mid_block.resnets.0", p["mid_res_0"])
    _resnet(sd, f"{pfx}.mid_block.resnets.1", p["mid_res_1"])
    attn = p["mid_attn"]
    a = f"{pfx}.mid_block.attentions.0"
    _gn(sd, f"{a}.group_norm", attn["group_norm"])
    for src, dst in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out", "to_out.0")):
        _dense(sd, f"{a}.{dst}", attn[src])


def _1x1(sd: Dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None, None])
    sd[f"{name}.bias"] = _t(p["bias"])


def vae_params_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    p = flax_params.get("params", flax_params)
    sd: Dict[str, torch.Tensor] = {}
    enc = p["encoder"]
    _conv(sd, "encoder.conv_in", enc["conv_in"])
    i = 0
    while f"down_{i}_res_0" in enc:
        j = 0
        while f"down_{i}_res_{j}" in enc:
            _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", enc[f"down_{i}_res_{j}"])
            j += 1
        if f"down_{i}_downsample" in enc:
            _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                  enc[f"down_{i}_downsample"]["conv"])
        i += 1
    _mid(sd, "encoder", enc)
    _gn(sd, "encoder.conv_norm_out", enc["conv_norm_out"])
    _conv(sd, "encoder.conv_out", enc["conv_out"])
    _1x1(sd, "quant_conv", p["quant_conv"])

    dec = p["decoder"]
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    _mid(sd, "decoder", dec)
    i = 0
    while f"up_{i}_res_0" in dec:
        j = 0
        while f"up_{i}_res_{j}" in dec:
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", dec[f"up_{i}_res_{j}"])
            j += 1
        if f"up_{i}_upsample" in dec:
            _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", dec[f"up_{i}_upsample"]["conv"])
        i += 1
    _gn(sd, "decoder.conv_norm_out", dec["conv_norm_out"])
    _conv(sd, "decoder.conv_out", dec["conv_out"])
    _1x1(sd, "post_quant_conv", p["post_quant_conv"])
    return sd


# the 2022 diffusers AttentionBlock names -> this package's (current diffusers)
_LEGACY_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}
_SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors: an 8-byte little-endian
    header length, a JSON header of dtype / shape / data_offsets, then the
    data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        dt = _SAFETENSORS_DTYPES[info["dtype"]]
        count = (end - start) // dt.itemsize
        flat = (torch.frombuffer(data, dtype=dt, count=count, offset=start) if count
                else torch.empty(0, dtype=dt))
        out[name] = flat.reshape(info["shape"]).clone()
    return out


def diffusers_vae_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A diffusers AutoencoderKL state dict in this package's names: the
    legacy attention names mapped, 4-D 1x1 attention weights squeezed,
    every tensor f32. Encoder, decoder and both quant convs are kept."""
    out = {}
    for key, v in sd.items():
        parts = key.split(".")
        if ".attentions." in key and len(parts) >= 2 and parts[-2] in _LEGACY_ATTN:
            key = ".".join(parts[:-2] + [_LEGACY_ATTN[parts[-2]], parts[-1]])
        if ".attentions." in key and key.endswith(".weight") and v.dim() == 4:
            v = v[:, :, 0, 0]
        out[key] = v.detach().to(torch.float32)
    return out


def load_vae_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A diffusers VAE checkpoint (``.safetensors``, or a ``torch.save``d
    state dict) ready for ``AutoencoderKL.load_state_dict``."""
    if path.endswith(".safetensors"):
        return diffusers_vae_state_dict(read_safetensors(path))
    return diffusers_vae_state_dict(torch.load(path, map_location="cpu", weights_only=True))
