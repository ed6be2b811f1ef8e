"""lfm_tpu EDM params -> this package's ``state_dict`` of DhariwalUNet, its
context variant or SongUNet.

The inverse of lfm_tpu/nn/convert_edm.py: its input is a flax param tree
(``{"params": ...}`` or the inner dict) as numpy arrays, whose modules are
named as the reference's with the first dot an underscore
(``enc_16x16_block0`` for ``enc.16x16_block0``). The output uses the
reference's key names (models/EDM.py), which the port's modules have, so a
released ``model_{E}.pth`` and this dict load the same way.

Layouts: conv kernel HWIO -> weight OIHW (under ``<path>/conv`` in flax);
Dense kernel (in, out) -> Linear weight (out, in), or the reference's 1x1
conv weight (out, in, 1, 1) for a block's attention ``qkv`` and ``proj``
(a context block's cross-attention keeps Linear layers); GroupNorm
scale/bias (under ``<path>/norm``) -> weight/bias; NCSN++'s ``freqs`` ->
``map_noise.freqs``; the context variant's label table ``map_label/
embedding`` -> ``map_label.embedding_table.weight``. The fixed
``resample_filter`` buffers, which flax does not hold, are added for every
resampling convolution: a block's ``conv0`` and ``skip`` where it goes up
or down, SongUNet's ``aux_down``, ``aux_residual`` and ``aux_up``, all
with the network's filter (``resample_filter``: [1, 1] for DhariwalUNet
and DDPM++, [1, 3, 3, 1] for NCSN++).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from lfm_tpu_torch.nn.edm_unet import RESAMPLE_FILTER, resample_kernel

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


def _value(path: Tuple[str, ...], a: np.ndarray) -> Tuple[str, np.ndarray]:
    """The state_dict key of a flax leaf and its value in torch's layout."""
    leaf = path[-1]
    if leaf == "freqs":
        return "map_noise.freqs", a
    if leaf == "embedding":
        return f"{_module_name(path[:-1])}.embedding_table.weight", a
    name = _module_name(path[:-1])
    if leaf in ("bias", "scale"):
        return f"{name}.{'bias' if leaf == 'bias' else 'weight'}", a
    if a.ndim == 4:
        return f"{name}.weight", a.transpose(3, 2, 0, 1)
    cross_attention = len(path) >= 3 and path[-3].startswith("attn")
    if path[-2] in _DENSE_1X1 and not cross_attention:
        return f"{name}.weight", a.T[:, :, None, None]
    return f"{name}.weight", a.T


def _resampling_convs(keys) -> list:
    """The module names that hold a ``resample_filter``, read from the
    parameter names: each up or down block's conv0 and skip (the skip may
    have no weights), SongUNet's aux_residual, an aux_down beside each
    aux_skip, and an aux_up beside each aux_norm but the lowest
    resolution's where the decoder has several (the ``skip`` decoder)."""
    modules = {k.rsplit(".", 1)[0] for k in keys}
    convs = set()
    for m in modules:
        block = re.match(r"^((enc|dec)\.\d+x\d+_(down|up))(\.base)?\.", m + ".")
        if block:
            convs.update(f"{block.group(1)}{block.group(4) or ''}.{c}" for c in ("conv0", "skip"))
        if m.endswith("_aux_residual"):
            convs.add(m)
        if m.endswith("_aux_skip"):
            convs.add(m[: -len("_aux_skip")] + "_aux_down")
    aux_norms = sorted((m for m in modules if m.endswith("_aux_norm")),
                       key=lambda m: int(re.search(r"\.(\d+)x", m).group(1)))
    if len(aux_norms) > 1:
        convs.update(m[: -len("_aux_norm")] + "_aux_up" for m in aux_norms[1:])
    return sorted(convs)


def edm_params_from_jax(flax_params: Mapping,
                        resample_filter: Sequence[float] = RESAMPLE_FILTER
                        ) -> Dict[str, torch.Tensor]:
    p = flax_params.get("params", flax_params)
    sd: Dict[str, torch.Tensor] = {}
    for path, a in _leaves(p):
        key, value = _value(path, a)
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    for conv in _resampling_convs(sd):
        sd[f"{conv}.resample_filter"] = resample_kernel(resample_filter)
    return sd
