"""lfm_tpu DiT params -> this package's DiT ``state_dict``.

The inverse of lfm_tpu/nn/convert_dit.py: its input is a flax param tree
(``{"params": ...}`` or the inner dict) as numpy arrays, with the blocks
stacked along axis 0 (the ``nn.scan`` layout, ``blocks/block/...``). The
output uses the reference's key names (models/DiT.py), so a released
``model_{E}.pth`` (after dropping its fixed ``pos_embed`` buffer and any
``module.`` prefix) loads into the same module.

Layouts: Dense kernel (in, out) -> Linear weight (out, in); the patch
embedding's (p*p*C, D) matmul kernel over (ph, pw, c)-ordered patches ->
conv weight (D, C, p, p).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _linear(sd: Dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def dit_params_from_jax(flax_params: Mapping, *, in_channels: int = 4) -> Dict[str, torch.Tensor]:
    p = flax_params.get("params", flax_params)
    sd: Dict[str, torch.Tensor] = {}

    k = np.asarray(p["x_embedder"]["proj"]["kernel"])  # (p*p*C, D)
    patch = int(round((k.shape[0] // in_channels) ** 0.5))
    d = k.shape[1]
    sd["x_embedder.proj.weight"] = _t(
        k.reshape(patch, patch, in_channels, d).transpose(3, 2, 0, 1))
    sd["x_embedder.proj.bias"] = _t(p["x_embedder"]["proj"]["bias"])

    _linear(sd, "t_embedder.mlp.0", p["t_embedder"]["fc1"])
    _linear(sd, "t_embedder.mlp.2", p["t_embedder"]["fc2"])
    sd["y_embedder.embedding_table.weight"] = _t(p["y_embedder"]["embedding"])

    blocks = p["blocks"]["block"]
    depth = np.asarray(blocks["adaLN_modulation"]["kernel"]).shape[0]
    for i in range(depth):
        def at(tree):
            return {kk: np.asarray(v)[i] for kk, v in tree.items()}
        pfx = f"blocks.{i}"
        _linear(sd, f"{pfx}.adaLN_modulation.1", at(blocks["adaLN_modulation"]))
        _linear(sd, f"{pfx}.attn.qkv", at(blocks["attn"]["qkv"]))
        _linear(sd, f"{pfx}.attn.proj", at(blocks["attn"]["proj"]))
        _linear(sd, f"{pfx}.mlp.fc1", at(blocks["mlp"]["fc1"]))
        _linear(sd, f"{pfx}.mlp.fc2", at(blocks["mlp"]["fc2"]))

    fl = p["final_layer"]
    _linear(sd, "final_layer.adaLN_modulation.1", fl["adaLN_modulation"])
    _linear(sd, "final_layer.linear", fl["linear"])
    return sd
