"""lfm_tpu ADM UNet params -> this package's ``UNetModel`` ``state_dict``.

The inverse of lfm_tpu/nn/convert_adm.py: its input is a flax param tree
(``{"params": ...}`` or the inner dict) as numpy arrays, whose layers are
named ``input_{i}_{j}``, ``middle_{j}`` and ``output_{i}_{j}`` by the same
``build_unet_plan``. The output uses the reference's key names
(models/guided_diffusion/unet.py), which the port's module has, so a
released ``model_{E}.pth`` and this dict load the same way.

Layouts: conv kernel HWIO -> weight OIHW; Dense kernel (in, out) -> Linear
weight (out, in), or the reference's Conv1d weight (out, in, 1) for the
attention's ``qkv`` and ``proj_out``; GroupNorm scale/bias -> weight/bias.
The layout variant's SpatialTransformers (``norm``, ``proj_in``,
``block_{d}/{norm1-3, attn1, attn2, ff/geglu/proj, ff/fc_out}``,
``proj_out`` in flax) take the LDM names of nn/attention.py:
``proj_in`` and ``proj_out`` as 1x1 convolutions (out, in, 1, 1),
``transformer_blocks.{d}.attn{1,2}.to_q|to_k|to_v|to_out.0``,
``.ff.net.0.proj`` and ``.ff.net.2``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from lfm_tpu_torch.nn.adm_unet import LayerSpec, UNetPlan


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _conv(sd: Dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{name}.bias"] = _t(p["bias"])


def _dense(sd: Dict, name: str, p: Mapping, conv1d: bool = False) -> None:
    w = np.asarray(p["kernel"]).T
    sd[f"{name}.weight"] = _t(w[:, :, None] if conv1d else w)
    sd[f"{name}.bias"] = _t(p["bias"])


def _gn(sd: Dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(p["norm"]["scale"])
    sd[f"{name}.bias"] = _t(p["norm"]["bias"])


def _norm(sd: Dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def spatial_transformer_params_from_jax(sd: Dict, pfx: str, p: Mapping) -> None:
    """A flax ``SpatialTransformer``'s params into ``sd`` under ``pfx``."""
    _norm(sd, f"{pfx}.norm", p["norm"])
    for name in ("proj_in", "proj_out"):
        _dense(sd, f"{pfx}.{name}", p[name])
        sd[f"{pfx}.{name}.weight"] = sd[f"{pfx}.{name}.weight"][:, :, None, None]
    depth = sum(k.startswith("block_") for k in p)
    for d in range(depth):
        b, q = f"{pfx}.transformer_blocks.{d}", p[f"block_{d}"]
        for norm in ("norm1", "norm2", "norm3"):
            _norm(sd, f"{b}.{norm}", q[norm])
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                sd[f"{b}.{attn}.{proj}.weight"] = _t(np.asarray(q[attn][proj]["kernel"]).T)
            _dense(sd, f"{b}.{attn}.to_out.0", q[attn]["to_out"])
        _dense(sd, f"{b}.ff.net.0.proj", q["ff"]["geglu"]["proj"])
        _dense(sd, f"{b}.ff.net.2", q["ff"]["fc_out"])


def layer_params_from_jax(sd: Dict, pfx: str, spec: LayerSpec, p: Mapping) -> None:
    """One layer of the plan (flax ``p``) into ``sd`` under ``pfx``."""
    if spec.kind == "conv_in":
        _conv(sd, pfx, p)
    elif spec.kind in ("res", "res_down", "res_up"):
        _gn(sd, f"{pfx}.in_layers.0", p["in_norm"])
        _conv(sd, f"{pfx}.in_layers.2", p["in_conv"])
        _dense(sd, f"{pfx}.emb_layers.1", p["emb_proj"])
        _gn(sd, f"{pfx}.out_layers.0", p["out_norm"])
        _conv(sd, f"{pfx}.out_layers.3", p["out_conv"])
        if "skip" in p:
            _conv(sd, f"{pfx}.skip_connection", p["skip"])
    elif spec.kind == "attn" and "proj_in" in p:
        spatial_transformer_params_from_jax(sd, pfx, p)
    elif spec.kind == "attn":
        _gn(sd, f"{pfx}.norm", p["norm"])
        _dense(sd, f"{pfx}.qkv", p["qkv"], conv1d=True)
        _dense(sd, f"{pfx}.proj_out", p["proj_out"], conv1d=True)
    elif spec.kind == "down":
        if "op" in p:
            _conv(sd, f"{pfx}.op", p["op"])
    elif spec.kind == "up":
        if "conv" in p:
            _conv(sd, f"{pfx}.conv", p["conv"])
    else:
        raise ValueError(spec.kind)


def adm_params_from_jax(flax_params: Mapping, plan: UNetPlan) -> Dict[str, torch.Tensor]:
    p = flax_params.get("params", flax_params)
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "time_embed.0", p["time_embed_1"])
    _dense(sd, "time_embed.2", p["time_embed_2"])
    if "label_emb" in p:
        sd["label_emb.weight"] = _t(p["label_emb"])
    for i, block in enumerate(plan.input_blocks):
        for j, spec in enumerate(block):
            layer_params_from_jax(sd, f"input_blocks.{i}.{j}", spec, p[f"input_{i}_{j}"])
    for j, spec in enumerate(plan.middle_block):
        layer_params_from_jax(sd, f"middle_block.{j}", spec, p[f"middle_{j}"])
    for i, block in enumerate(plan.output_blocks):
        for j, spec in enumerate(block):
            layer_params_from_jax(sd, f"output_blocks.{i}.{j}", spec, p[f"output_{i}_{j}"])
    _gn(sd, "out.0", p["out_norm"])
    _conv(sd, "out.2", p["out_conv"])
    return sd
