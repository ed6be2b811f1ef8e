"""COUNTLESS segmentation downsampling, 2D and 3D (port of
lfm_tpu/data/countless.py; reference datasets_prep/inpaint_preprocess/masks/
countless/countless2d.py:26-51, countless3d.py:44-68), on numpy arrays and
on torch tensors (which the JAX package takes as ``xp=jnp`` arrays).

Each 2x2 (or 2x2x2) block becomes its mode with element-wise operations
only: a value is the mode when some m-subset of the block's positions all
hold it, for the largest such m, checked over the position subsets of size
floor(K/2) down to 2 with equality and select; with no repeat the last
position wins. Ties go to the first matching subset in lexicographic order,
as in the reference. The labels are shifted by +1 first (zero would defeat
the ``x + (x == 0) * y`` select), in a wider integer type where the input's
cannot hold max + 1, and shifted back. Any leading axes are batch axes.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

__all__ = ["countless2d", "countless3d", "downsample_segmentation"]


def _sections(data, factor):
    """The strided sub-arrays of the trailing ``len(factor)`` axes, one per
    in-block position, in lexicographic order."""
    lead = (slice(None),) * (data.ndim - len(factor))
    return [data[lead + tuple(slice(o, None, f) for o, f in zip(offset, factor))]
            for offset in np.ndindex(*factor)]


def _widen(data):
    """``data`` in an integer type that holds data.max() + 1, plus one."""
    if isinstance(data, torch.Tensor):
        if data.is_floating_point() or data.is_complex() or data.dtype == torch.bool:
            raise TypeError(f"countless needs an integer label map, got {data.dtype}")
        wide = torch.int16 if data.dtype in (torch.uint8, torch.int8) else data.dtype
        return data.to(wide) + 1
    dt = data.dtype
    if np.issubdtype(dt, np.unsignedinteger):
        # uint8 label maps hold 255: the shift needs headroom
        wide = np.uint16 if np.iinfo(dt).bits == 8 else dt
    elif np.issubdtype(dt, np.signedinteger):
        wide = np.int16 if np.iinfo(dt).bits == 8 else dt
    else:
        raise TypeError(f"countless needs an integer label map, got {dt}")
    return data.astype(wide) + 1


def _lor(x, y):
    """x where non-zero, else y (both shifted)."""
    return x + (x == 0) * y


def _countless(data, factor):
    parts = _sections(_widen(data), factor)
    k = len(parts)
    # a value on more than floor(k/2) positions fills some floor(k/2)-subset
    # that no rival can tie, so subset sizes 2..floor(k/2) suffice; the
    # levels build bottom-up, and the final select takes the largest first
    levels = {}
    memo = {(i,): parts[i] for i in range(k)}
    for m in range(2, k // 2 + 1):
        acc, nxt = None, {}
        for idx in combinations(range(k), m):
            prefix = memo[idx[:-1]]
            val = prefix * (prefix == parts[idx[-1]])
            nxt[idx] = val
            if m == 2 and idx[-1] == k - 1:
                continue  # a pair with the last position: the fallback gives it
            acc = val if acc is None else _lor(acc, val)
        levels[m] = acc
        memo = nxt
    result = parts[-1]  # the fallback: the block's last position
    for m in sorted(levels):
        result = _lor(levels[m], result)
    result = result - 1
    return result.to(data.dtype) if isinstance(data, torch.Tensor) else result.astype(data.dtype)


def countless2d(data):
    """The trailing 2 axes of an integer label map halved by 2x2 modes, its
    dtype kept; numpy in, numpy out, torch in, torch out."""
    if data.shape[-1] % 2 or data.shape[-2] % 2:
        raise ValueError(f"trailing axes must be even, got {tuple(data.shape)}")
    return _countless(data, (2, 2))


def countless3d(data):
    """The trailing 3 axes halved by 2x2x2 modes."""
    if any(data.shape[i] % 2 for i in (-3, -2, -1)):
        raise ValueError(f"trailing axes must be even, got {tuple(data.shape)}")
    return _countless(data, (2, 2, 2))


def downsample_segmentation(seg, factor: int):
    """countless2d repeated until the trailing 2 axes shrink by ``factor``
    (a power of two): the mode-of-modes mip chain of a label map."""
    if factor < 1 or factor & (factor - 1):
        raise ValueError(f"factor must be a power of two, got {factor}")
    while factor > 1:
        seg = countless2d(seg)
        factor //= 2
    return seg
