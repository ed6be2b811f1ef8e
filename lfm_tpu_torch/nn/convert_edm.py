"""lfm_tpu EDM params -> this package's ``DhariwalUNet`` ``state_dict``.

The inverse of lfm_tpu/nn/convert_edm.py: its input is a flax param tree
(``{"params": ...}`` or the inner dict) as numpy arrays, whose modules are
named as the reference's with the first dot an underscore
(``enc_16x16_block0`` for ``enc.16x16_block0``). The output uses the
reference's key names (models/EDM.py), which the port's module has, so a
released ``model_{E}.pth`` and this dict load the same way.

Layouts: conv kernel HWIO -> weight OIHW (under ``<path>/conv`` in flax);
Dense kernel (in, out) -> Linear weight (out, in), or the reference's 1x1
conv weight (out, in, 1, 1) for the attention's ``qkv`` and ``proj``;
GroupNorm scale/bias (under ``<path>/norm``) -> weight/bias. The fixed
``resample_filter`` buffers, which flax does not hold, are added for every
up and down block (the [1, 1] filter of DhariwalUNet).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from lfm_tpu_torch.nn.edm_unet import resample_kernel

_DENSE_1X1 = {"qkv", "proj"}


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), np.asarray(value, dtype=np.float32)


def _module_name(path: Tuple[str, ...]) -> str:
    """('enc_8x8_block0', 'norm0', 'norm') -> 'enc.8x8_block0.norm0'."""
    parts = [p for p in path if p not in ("conv", "norm")]
    head, _, rest = parts[0].partition("_")
    if head in ("enc", "dec"):
        parts[0:1] = [head, rest]
    return ".".join(parts)


def edm_params_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    p = flax_params.get("params", flax_params)
    sd: Dict[str, torch.Tensor] = {}
    for path, a in _leaves(p):
        name, leaf = _module_name(path[:-1]), path[-1]
        if leaf in ("bias", "scale"):
            value = a
        elif a.ndim == 4:
            value = a.transpose(3, 2, 0, 1)
        elif path[-2] in _DENSE_1X1:
            value = a.T[:, :, None, None]
        else:
            value = a.T
        sd[f"{name}.{'bias' if leaf == 'bias' else 'weight'}"] = torch.from_numpy(
            np.ascontiguousarray(value))
    blocks = {".".join(k.split(".")[:2]) for k in sd}
    for block in sorted(b for b in blocks if b.endswith(("_down", "_up"))):
        for conv in ("conv0", "skip"):
            sd[f"{block}.{conv}.resample_filter"] = resample_kernel()
    return sd
