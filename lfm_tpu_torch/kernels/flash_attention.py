"""Small-T attention: the CUDA kernel K1 and its plain version.

Port of lfm_tpu/kernels/flash_attention.py::attention_small (the Pallas
kernel `_attn_small_kernel`): whole-sequence, non-causal softmax attention
per head, scale 1/sqrt(D), f32 max / sum / accumulation, p rounded to the
input type before the PV product. The kernel is
``csrc/attention.cuh``; what bounds it is noted there.

On a CPU tensor ``attention_small`` computes the plain version; on a CUDA
tensor it launches the kernel or raises. The long-T ``flash_attention``
(K4) and the backward (K3) are later slices. There is no autograd here:
sampling runs under ``torch.no_grad``.
"""

from __future__ import annotations

import math

import torch

from lfm_tpu_torch.kernels._build import LaunchCounter, check_rc, load_library

ATTENTION_SMALL = LaunchCounter()
# head dims the kernel is built for: DiT-S/B/L use 64, DiT-XL 72
HEAD_DIMS = (56, 64, 72, 80)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention (flash_attention.py::reference_attention): f32
    scores and softmax, probs rounded to q's type, PV accumulated in f32."""
    d = q.shape[-1]
    s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float())
    p = torch.softmax(s / math.sqrt(d), dim=-1).to(q.dtype)
    return torch.einsum("nhqk,nkhd->nqhd", p.float(), v.float()).to(q.dtype)


def _small_shape_ok(q: torch.Tensor) -> bool:
    """The JAX package's gate for the whole-sequence kernel."""
    n, t, h, d = q.shape
    return t <= 1024 and (3 * t * h * d * 4 + t * t * 4) < 96 * 1024 * 1024


def _check_slab(name: str, a: torch.Tensor, ref: torch.Tensor) -> None:
    n, t, h, d = ref.shape
    if a.device != ref.device or a.dtype != torch.bfloat16 or a.shape != ref.shape:
        raise ValueError(f"attention_small: {name} must be bf16 {tuple(ref.shape)} on "
                         f"{ref.device}, got {a.dtype} {tuple(a.shape)} on {a.device}")
    ld = a.stride(1)
    if a.stride(3) != 1 or a.stride(2) != d or a.stride(0) != t * ld or ld % 8:
        raise ValueError(f"attention_small: {name} needs (T, H*D) rows with unit stride "
                         f"inside a row and a row stride that is a multiple of 8; "
                         f"got strides {a.stride()}")
    if a.data_ptr() % 16:
        raise ValueError(f"attention_small: {name} is not 16-byte aligned")


def attention_small(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (N, T, H, D) -> (N, T, H, D), T <= 1024, scale 1/sqrt(D).

    On CUDA: bf16, D in HEAD_DIMS; each of q, k, v may be a view
    whose (T, H*D) rows have any row stride (such as the thirds of a fused
    qkv tensor), and is read in place."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"attention_small: unsupported device {q.device}")
    n, t, h, d = q.shape
    if not _small_shape_ok(q):
        raise ValueError(f"attention_small: T={t} is past the small-T gate")
    if d not in HEAD_DIMS:
        raise ValueError(f"attention_small: head dim {d} is not one of {HEAD_DIMS}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        _check_slab(name, a, q)
    out = torch.empty((n, t, h, d), dtype=q.dtype, device=q.device)
    lib = load_library()
    rc = lib.lfm_attention_small(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n, t, h, d,
        q.stride(1), k.stride(1), v.stride(1), h * d,
        torch.cuda.current_stream(q.device).cuda_stream)
    check_rc("attention_small", rc)
    ATTENTION_SMALL.count += 1
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dispatch as ``_dispatch_attention`` does: the small-T kernel within
    its gate; past it the plain version on the CPU, and on CUDA an error
    until the long-T kernel (K4) is ported."""
    if _small_shape_ok(q):
        return attention_small(q, k, v)
    if q.device.type == "cpu":
        return reference_attention(q, k, v)
    raise NotImplementedError(
        f"attention at T={q.shape[1]} needs the long-T flash_attention kernel, "
        "which is not ported yet")
