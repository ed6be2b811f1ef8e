"""lfm_tpu VAE params -> this package's AutoencoderKL ``state_dict``.

The inverse of lfm_tpu/vae/convert.py for the parts this package has (the
decoder and ``post_quant_conv``). Input: a flax param tree (``{"params":
...}`` or the inner dict) as numpy arrays. Output: diffusers key names.

Layouts: conv HWIO -> OIHW; attention Dense (in, out) -> Linear (out, in);
``post_quant_conv`` Dense (4, 4) -> 1x1 conv (4, 4, 1, 1); GroupNorm
scale/bias -> weight/bias.
"""

from __future__ import annotations

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


def vae_params_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    p = flax_params.get("params", flax_params)
    dec = p["decoder"]
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    _resnet(sd, "decoder.mid_block.resnets.0", dec["mid_res_0"])
    _resnet(sd, "decoder.mid_block.resnets.1", dec["mid_res_1"])
    attn = dec["mid_attn"]
    a = "decoder.mid_block.attentions.0"
    _gn(sd, f"{a}.group_norm", attn["group_norm"])
    for src, dst in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out", "to_out.0")):
        _dense(sd, f"{a}.{dst}", attn[src])
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
    pq = p["post_quant_conv"]
    sd["post_quant_conv.weight"] = _t(np.asarray(pq["kernel"]).T[:, :, None, None])
    sd["post_quant_conv.bias"] = _t(pq["bias"])
    return sd
