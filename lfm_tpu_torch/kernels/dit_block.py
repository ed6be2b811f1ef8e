"""Fused DiT block: the CUDA kernel K2 and its plain version.

Port of lfm_tpu/kernels/dit_block.py::fused_dit_block (the Pallas kernel
`_dit_block_kernel`): LayerNorm -> adaLN modulate -> qkv -> per-head
attention -> proj -> gated residual -> LayerNorm -> modulate -> fc1 ->
tanh-GELU -> fc2 -> gated residual, with the TPU kernel's bf16 rounding
points and an f32 residual between the halves. The kernel sequence is
``csrc/dit_block.cu``; what bounds it is noted there.

Weights are in ``torch.nn.Linear`` layout (out_features, in_features); the
JAX kernel takes flax's (in, out). On a CPU tensor ``fused_dit_block``
computes the plain version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from lfm_tpu_torch.kernels._build import LaunchCounter, check_rc, load_library
from lfm_tpu_torch.kernels.flash_attention import HEAD_DIMS

FUSED_DIT_BLOCK = LaunchCounter()
_LN_EPS = 1e-6


def layernorm_f32(x: torch.Tensor) -> torch.Tensor:
    """No-affine LayerNorm, var = E[x^2] - E[x]^2 (dit_block.py::_layernorm_f32)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.square().mean(dim=-1, keepdim=True) - mu.square()
    return (x - mu) * torch.rsqrt(var + _LN_EPS)


def _mm(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 accumulation, f32 bias: a @ w^T + b in f32."""
    return F.linear(a.float(), w.float(), b.float())


def reference_block(x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2, *,
                    num_heads: int) -> torch.Tensor:
    """Plain version of the kernel (dit_block_train.py::reference_block)."""
    n, t, c = x.shape
    hd = c // num_heads
    scale = 1.0 / math.sqrt(hd)
    mod3 = mod.reshape(n, 6, c).float()
    sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = (mod3[:, i, None, :] for i in range(6))

    xf = x.float()
    h = (layernorm_f32(xf) * (1.0 + sc_msa) + sh_msa).to(torch.bfloat16)
    qkv = _mm(h, wqkv, bqkv).to(torch.bfloat16)
    q, k, v = (a.reshape(n, t, num_heads, hd) for a in qkv.split(c, dim=-1))
    logits = scale * torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float())
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("nhqk,nkhd->nqhd", p.to(torch.bfloat16).float(), v.float())
    ao = o.to(torch.bfloat16).reshape(n, t, c)
    x1 = xf + g_msa * _mm(ao, wproj, bproj)

    h = (layernorm_f32(x1) * (1.0 + sc_mlp) + sh_mlp).to(torch.bfloat16)
    g = F.gelu(_mm(h, w1, b1), approximate="tanh")
    x2 = x1 + g_mlp * _mm(g.to(torch.bfloat16), w2, b2)
    return x2.to(x.dtype)


def _check(name: str, a: torch.Tensor, shape, device) -> None:
    if a.device != device or a.dtype != torch.bfloat16 or tuple(a.shape) != tuple(shape):
        raise ValueError(f"fused_dit_block: {name} must be bf16 {tuple(shape)} on {device}, "
                         f"got {a.dtype} {tuple(a.shape)} on {a.device}")
    if not a.is_contiguous():
        raise ValueError(f"fused_dit_block: {name} must be contiguous")


def fused_dit_block(x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2, *,
                    num_heads: int) -> torch.Tensor:
    """One DiT block. x: (N, T, C); mod: (N, 6C), the adaLN modulation
    (the block's SiLU + Dense of the conditioning, computed outside).

    On CUDA: all bf16 and contiguous, C % 128 == 0, hidden % 128 == 0,
    head dim C / num_heads in HEAD_DIMS, T <= 1024."""
    if x.device.type == "cpu":
        return reference_block(x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2,
                               num_heads=num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dit_block: unsupported device {x.device}")
    n, t, c = x.shape
    hidden = w1.shape[0]
    hd = c // num_heads
    if c % 128 or hidden % 128 or c % num_heads or hd not in HEAD_DIMS or t > 1024:
        raise ValueError(f"fused_dit_block: unsupported shape C={c} hidden={hidden} "
                         f"heads={num_heads} T={t}")
    dev = x.device
    for name, a, shape in (("x", x, (n, t, c)), ("mod", mod, (n, 6 * c)),
                           ("wqkv", wqkv, (3 * c, c)), ("bqkv", bqkv, (3 * c,)),
                           ("wproj", wproj, (c, c)), ("bproj", bproj, (c,)),
                           ("w1", w1, (hidden, c)), ("b1", b1, (hidden,)),
                           ("w2", w2, (c, hidden)), ("b2", b2, (c,))):
        _check(name, a, shape, dev)
    m = n * t
    bf = torch.bfloat16
    out = torch.empty_like(x)
    h = torch.empty((m, c), dtype=bf, device=dev)
    qkv = torch.empty((m, 3 * c), dtype=bf, device=dev)
    ao = torch.empty((m, c), dtype=bf, device=dev)
    x1 = torch.empty((m, c), dtype=torch.float32, device=dev)
    u = torch.empty((m, hidden), dtype=bf, device=dev)
    lib = load_library()
    rc = lib.lfm_dit_block(
        x.data_ptr(), mod.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
        wproj.data_ptr(), bproj.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), h.data_ptr(), qkv.data_ptr(),
        ao.data_ptr(), x1.data_ptr(), u.data_ptr(), n, t, c, hidden, num_heads,
        torch.cuda.current_stream(dev).cuda_stream)
    check_rc("fused_dit_block", rc)
    FUSED_DIT_BLOCK.count += 1
    return out
