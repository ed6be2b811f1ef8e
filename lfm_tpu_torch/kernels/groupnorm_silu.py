"""Fused GroupNorm + SiLU: the CUDA kernel K6 and its plain version (port
of lfm_tpu/kernels/groupnorm_silu.py).

K6 ports ``groupnorm_silu`` (the Pallas kernel `_gn_silu_kernel`): per
sample, GroupNorm over NHWC with f32 statistics (32 groups, eps 1e-5), then
the affine, then SiLU, in one kernel (``csrc/groupnorm_silu.cu``, where
what bounds it and the design are noted). It reads x once, in its own type
(bf16 or f32), holds it on chip between the statistics and the normalise,
and writes the same type, with f32 inside: the values of the JAX module,
which casts to f32 around its kernel. Its statistics are two-pass, as
``reference_groupnorm_silu``'s are; the TPU kernel's are E[x^2] - mean^2.
``gn_plan`` states the launch the kernel makes for a shape (the C rule
``gn_make_plan``, which ``lfm_groupnorm_silu_plan`` returns on the card).

On a CPU tensor ``groupnorm_silu`` computes the plain version; on a CUDA
tensor it launches K6 or raises. The ADM UNet's ResBlocks reach it through
``FusedGNSiLU.apply`` with ``use_fused_gn``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lfm_tpu_torch.kernels._build import LaunchCounter, check_rc, load_library

GROUPNORM_SILU = LaunchCounter()
DTYPES = (torch.bfloat16, torch.float32)
# csrc/groupnorm_silu.cu's constants
MAX_THREADS, MIN_THREADS, CHUNKS_PER_THREAD = 512, 64, 16
SPAN_BYTES, CTA_BYTES, SMEM_MAX, MAX_CLUSTER = 64, 65536, 232448, 8


class GnPlan(NamedTuple):
    """K6's launch for one shape (``GnPlan`` of csrc/groupnorm_silu.cu, in its
    order): elements of a chunk (16 bytes, or 1 at the scalar edge), groups
    an item, chunks of a pixel's span, lanes of a pixel, threads, CTAs of a
    cluster, whether the slab is held in shared memory, pixels a CTA,
    dynamic shared bytes, items (samples times group spans; the grid is
    items x cluster CTAs)."""

    vec: int
    gpc: int
    cpp: int
    p2: int
    threads: int
    cluster: int
    hold: int
    hwc: int
    smem: int
    items: int


def _pow2_at_least(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def gn_plan(n: int, hw: int, c: int, groups: int, dtype: torch.dtype,
            aligned: bool = True) -> GnPlan:
    """The launch K6 makes for x (n, hw, c) in ``dtype`` (``gn_make_plan``):
    an item is one sample and ``gpc`` whole groups, a CTA its ``hwc``
    pixels. Chunks are 16 bytes where a group's bytes are a multiple of 16
    and x and out are 16-byte aligned, else one element. The span is the
    fewest groups that make SPAN_BYTES or more a pixel, in whole 32-byte
    sectors where the chunks are 16 bytes; the smallest cluster whose CTAs
    hold at most CTA_BYTES of the slab splits its pixels (else the largest,
    which streams x where its part does not fit SMEM_MAX); the threads give
    each about CHUNKS_PER_THREAD chunks."""
    if groups < 1 or c % groups or n < 1 or hw < 1 or n * groups * MAX_CLUSTER > 2 ** 31 - 1:
        raise ValueError(f"groupnorm_silu: no launch for N {n}, HW {hw}, C {c}, groups {groups}")
    esize = torch.empty((), dtype=dtype).element_size()
    cg = c // groups
    vector = aligned and (cg * esize) % 16 == 0
    cbytes = 16 if vector else esize
    cpg = cg * esize // cbytes
    gbytes = hw * cg * esize
    gpc = 1
    while ((gpc * cg * esize < SPAN_BYTES or (vector and (gpc * cg * esize) % 32))
           and groups % (2 * gpc) == 0 and 2 * gpc * cpg <= MAX_THREADS):
        gpc *= 2
    cl = 1
    while cl < MAX_CLUSTER and -(-gpc * gbytes // cl) > CTA_BYTES:
        cl *= 2
    cpp = gpc * cpg
    p2 = _pow2_at_least(min(cpp, MAX_THREADS))
    hwc = -(-hw // cl)
    threads = min(max(_pow2_at_least(-(-hwc * p2 // CHUNKS_PER_THREAD)), p2, MIN_THREADS),
                  MAX_THREADS)
    slab = -(-hwc * cpp * cbytes // 16) * 16
    scratch = (2 * threads + 2 * gpc) * 4
    hold = int(slab + scratch <= SMEM_MAX)
    return GnPlan(cbytes // esize, gpc, cpp, p2, threads, cl, hold, hwc,
                  slab + scratch if hold else scratch, n * (groups // gpc))


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
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x, scale, bias)):
        # the kernel's output has no grad_fn: training through it would give
        # x, scale and bias no gradient at all (the JAX kernel has no VJP either)
        raise RuntimeError("groupnorm_silu: K6 has no backward; an operand requires grad "
                           "(ROADMAP Queue 1 item 10, K6 backward). Train with "
                           "use_fused_gn=False, as the JAX package does")
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
    version on a CPU tensor, K6 on a CUDA tensor, where it raises under grad
    if an operand requires grad (K6 has no backward). Callers own the scale
    and bias (the GroupNorm's weight and bias)."""

    apply = staticmethod(groupnorm_silu)
