"""Ring attention: exact self-attention over a sequence-split group of ranks
(port of lfm_tpu/core/ring.py).

The token axis is split over the ranks of the ``seq`` axis; each rank keeps
its q block and the k/v blocks travel round the ring (``ppermute``, one
neighbour a step), combined with the online-softmax recurrence, the
distributed form of the flash-attention update. After ``size`` steps every
q block has seen every k/v block. Differentiable, as JAX's is: the
recurrence is plain tensor arithmetic and ``ppermute``'s backward is the
shift the other way round.

JAX's two block products take the input dtype with f32 accumulation
(``preferred_element_type=jnp.float32``). A bf16 ``torch.matmul`` would
round its output to bf16, so the operands are raised to f32 instead: a
product of two bf16 values is exact in f32, and TF32, where it is on,
keeps a bf16 value's mantissa whole. The probabilities are rounded to v's
dtype before the second product, as JAX rounds them. JAX's ring is einsum
and no Pallas kernel, so no kernel of the port runs here either.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from lfm_tpu_torch.core.sharding import _group_size, ppermute

__all__ = ["ring_attention"]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention for sequence blocks; q, k, v: (N, T_local, H, D), this
    rank's contiguous tokens. Scores and the running statistics are f32;
    the output has q's dtype. ``group``: the seq axis's ranks (None: one)."""
    n, t_loc, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    size = _group_size(group)
    qf = q.float()
    acc = torch.zeros((n, h, t_loc, d), dtype=torch.float32, device=q.device)
    m = torch.full((n, h, t_loc, 1), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((n, h, t_loc, 1), dtype=torch.float32, device=q.device)
    # k and v travel as one tensor: one exchange, one backward node a step,
    # so every rank runs its collectives in the same order
    kv = torch.stack([k, v])
    for step in range(size):
        k_blk, v_blk = kv[0], kv[1]
        s = scale * torch.einsum("nqhd,nkhd->nhqk", qf, k_blk.float())
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("nhqk,nkhd->nhqd", p.to(v.dtype).float(),
                                         v_blk.float())
        m = m_new
        if step + 1 < size:  # JAX's last shift is discarded
            kv = ppermute(kv, group, 1)
    out = acc / l
    return out.transpose(1, 2).to(q.dtype)
