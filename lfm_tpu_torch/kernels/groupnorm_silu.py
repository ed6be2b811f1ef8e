"""Fused GroupNorm + SiLU: the CUDA kernel K6 and its plain version (port
of lfm_tpu/kernels/groupnorm_silu.py).

K6 ports ``groupnorm_silu`` (the Pallas kernel `_gn_silu_kernel`): per
sample, GroupNorm over NHWC with f32 statistics (32 groups, eps 1e-5), then
the affine, then SiLU, in one kernel (``csrc/groupnorm_silu.cu``, where
what bounds it is noted). It reads x in its own type (bf16 or f32) and
writes the same type, with f32 inside: the values of the JAX module, which
casts to f32 around its kernel. Its statistics are two-pass, as
``reference_groupnorm_silu``'s are; the TPU kernel's are E[x^2] - mean^2.

On a CPU tensor ``groupnorm_silu`` computes the plain version; on a CUDA
tensor it launches K6 or raises. The ADM UNet's ResBlocks reach it through
``FusedGNSiLU.apply`` with ``use_fused_gn``.
"""

from __future__ import annotations

import torch

from lfm_tpu_torch.kernels._build import LaunchCounter, check_rc, load_library

GROUPNORM_SILU = LaunchCounter()
DTYPES = (torch.bfloat16, torch.float32)


def reference_groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                             groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Plain version (groupnorm_silu.py::reference_groupnorm_silu): f32
    two-pass statistics per (sample, group), affine, SiLU, cast to x's type.
    x: (N, H, W, C); scale, bias: (C,)."""
    n, h, w, c = x.shape
    xg = x.float().reshape(n, h * w, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    y = y * scale.float() + bias.float()
    return (y * torch.sigmoid(y)).to(x.dtype)


def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """silu(groupnorm(x)) for x (N, H, W, C), C % groups == 0; scale and
    bias (C,). On CUDA: x contiguous, bf16 or f32; out in x's type."""
    if x.device.type == "cpu":
        return reference_groupnorm_silu(x, scale, bias, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_silu: unsupported device {x.device}")
    n, h, w, c = x.shape
    if x.dtype not in DTYPES:
        raise ValueError(f"groupnorm_silu: dtype {x.dtype} is not one of {DTYPES}")
    if c % groups or not x.is_contiguous():
        raise ValueError(f"groupnorm_silu needs contiguous NHWC with C % {groups} == 0; "
                         f"got {tuple(x.shape)} with strides {x.stride()}")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"groupnorm_silu: scale and bias must be ({c},), got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    rc = load_library().lfm_groupnorm_silu(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h * w, c, groups,
        eps, int(x.dtype == torch.float32), torch.cuda.current_stream(x.device).cuda_stream)
    check_rc("groupnorm_silu", rc)
    GROUPNORM_SILU.count += 1
    return out


class FusedGNSiLU:
    """What modules call (the JAX package's ``FusedGNSiLU``): the plain
    version on a CPU tensor, K6 on a CUDA tensor. Callers own the scale and
    bias (the GroupNorm's weight and bias)."""

    apply = staticmethod(groupnorm_silu)
