"""Attention: the CUDA kernels K1 (small-T forward), K3 (its backward) and
K4 (long-T forward), their plain versions, and the differentiable
``fused_attention``.

K1 ports lfm_tpu/kernels/flash_attention.py::attention_small (the Pallas
kernel `_attn_small_kernel`): whole-sequence, non-causal softmax attention
per head, scale 1/sqrt(D), f32 max / sum / accumulation, p rounded to the
input type before the PV product. K3 ports ``attention_small_bwd``
(`_attn_small_bwd_kernel`): dq, dk, dv with the probs recomputed, p and ds
rounded to the input type before their products.
K4 ports ``flash_attention`` (`_flash_kernel`): keys in blocks of
``block_k`` with an online softmax, f32 m, l and acc, p rounded to v's
type before PV, acc / l at the end. In bf16, K1 and K4 are one wgmma + TMA
kernel for Hopper (``csrc/attention_sm90.cuh``: whole-row mode up to T =
256, key blocks past it), and bf16 K3 two wgmma + TMA kernels
(``csrc/attention_bwd_sm90.cuh``); in f32 they are f32 FMA kernels
split by shape: f32 K1 and K3 at T <= 256 and D 56-80 (the f32 DiT's
attention, ``train --precision f32``) are one-pass, register-blocked
kernels (``csrc/attention_row_f32.cuh``); f32 K4, and f32 K1 and K3 past
T = 256, keep a whole key block (K4, at most 512 keys; K1, whose whole row
is one block of K4's kernel, at most 1024) or a whole row (K3's dq kernel)
of scores on chip with k and v streamed through a cp.async ring
(``csrc/attention_long_f32.cuh``; K3's dk/dv kernel is the row kernels');
f32 K1 at D = 128/256 (the origin ADM's attention) is a one-pass kernel
sized to T up to 64 (``csrc/attention_wide.cu``) and past it the same
key-block kernel with the whole row one block; its backward, f32 K3 at D =
128/256 (``csrc/attention_bwd_wide_f32.cu``), is one kernel that holds a
whole (sample, head) on chip and forms s and dp once at T <= 64 (48 at D =
256: every preset shape), and past it a dq kernel holding its query rows'
whole rows of s on chip and a dk/dv kernel streaming the queries, both
with register-blocked score tiles summed over slices of D.
``f32_k1_route`` and ``f32_k3_route`` state which f32 kernels a shape
takes. What bounds each is noted in its
source.

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor
it launches its kernel or raises. ``fused_attention_qkv`` is a
``torch.autograd.Function`` over a fused qkv row, the port of the
``fused_attention`` custom_vjp (``fused_attention`` packs separate q, k, v
into one): within the small-T gate K1 forward (qkv saved, not p) and K3
backward; past it K4 forward, and a backward that recomputes the plain
version through autograd on either device, as the JAX package's
``_fused_attention_bwd`` does in XLA (it has no long-T backward kernel).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from lfm_tpu_torch.kernels._build import LaunchCounter, check_rc, load_library

ATTENTION_SMALL = LaunchCounter()
ATTENTION_SMALL_BWD = LaunchCounter()
FLASH_ATTENTION = LaunchCounter()
# head dims every kernel is built for, in bf16 and f32: DiT-S/B/L use 64,
# DiT-XL 72
HEAD_DIMS = (56, 64, 72, 80)
# and in f32 only: the origin ADM's f32 attention at 128 (celeb256_adm) and
# 256 (celeb512_adm, church_adm), forward and backward
F32_HEAD_DIMS = {"attention_small": (128, 256), "attention_small_bwd": (128, 256),
                 "flash_attention": (128,)}
DTYPES = (torch.bfloat16, torch.float32)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention (flash_attention.py::reference_attention): f32
    scores and softmax, probs rounded to q's type, PV accumulated in f32."""
    d = q.shape[-1]
    s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float())
    p = torch.softmax(s / math.sqrt(d), dim=-1).to(q.dtype)
    return torch.einsum("nhqk,nkhd->nqhd", p.float(), v.float()).to(q.dtype)


def reference_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3 (`_attn_small_bwd_kernel`): f32 scores, softmax
    and ds correction; p and ds rounded to q's type before their products,
    which accumulate in f32. Returns (dq, dk, dv) in q's type."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = (a.float() for a in (q, k, v, do))
    s = scale * torch.einsum("nqhd,nkhd->nhqk", qf, kf)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.einsum("nhqk,nqhd->nkhd", p.to(dt).float(), dof)
    dp = torch.einsum("nqhd,nkhd->nhqk", dof, vf)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = scale * torch.einsum("nhqk,nkhd->nqhd", ds, kf)
    dk = scale * torch.einsum("nhqk,nqhd->nkhd", ds, qf)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def reference_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              block_k: int = 512) -> torch.Tensor:
    """Plain version of K4 (`_flash_kernel`): keys in blocks of
    ``_pick_block(T, block_k)``; per block f32 scores, m_new = max(m, block
    max), p = exp(s - m_new), l = alpha l + sum(p), acc = alpha acc + p V
    with p rounded to v's type and f32 accumulation; acc / l at the end."""
    n, t, h, d = q.shape
    bk = _pick_block(t, block_k)
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = (a.float().transpose(1, 2) for a in (q, k, v))  # (N, H, T, D)
    m = torch.full((n, h, t, 1), -math.inf, device=q.device)
    l = torch.zeros((n, h, t, 1), device=q.device)
    acc = torch.zeros((n, h, t, d), device=q.device)
    for b0 in range(0, t, bk):
        s = scale * (qf @ kf[:, :, b0:b0 + bk].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + p.to(v.dtype).float() @ vf[:, :, b0:b0 + bk]
        m = m_new
    return (acc / l).transpose(1, 2).to(q.dtype)


def _pick_block(t: int, target: int) -> int:
    """Largest divisor of t that is <= target (the JAX package's
    ``_pick_block``)."""
    b = min(t, target)
    while t % b:
        b -= 1
    return b


def _small_shape_ok(q: torch.Tensor) -> bool:
    """The JAX package's gate for the whole-sequence kernels."""
    n, t, h, d = q.shape
    return t <= 1024 and (3 * t * h * d * 4 + t * t * 4) < 96 * 1024 * 1024


def f32_k1_route(t: int, d: int) -> Tuple[str, int, int]:
    """The kernel that f32 ``attention_small`` launches at sequence length t
    and head dim d (``lfm_attention_small``, csrc/attention.cu), with its
    query rows a CTA and the keys it holds on chip at once: (kernel name,
    rows, keys)."""
    if d > 80 and t <= 64:  # the origin ADM's heads at short T (attention_wide.cu)
        keys = 16 if t <= 16 else 32 if t <= 32 else 64
        return "attn_short_f32_kernel", 16 if t <= 16 else 32, keys
    if d <= 80 and t <= 256:  # attention_row_f32.cuh
        return "attn_row_kernel", 64, 64 if t <= 64 else 128 if t <= 128 else 256
    # attention_long_f32.cuh, one block of T keys: K4's instances up to T =
    # 512, 32 query rows past it and at every T at D = 256
    if t <= 512 and d <= 128:
        return "flash_f32_kernel", 64, 512
    return "flash_f32_kernel", 32, 1024


def f32_k3_route(t: int, d: int) -> Tuple[Tuple[str, ...], int, int]:
    """The kernels that f32 ``attention_small_bwd`` launches at sequence
    length t and head dim d (``lfm_attention_small_bwd``,
    csrc/attention_bwd.cu), in launch order, with the query rows of a dq
    CTA and the keys of a dk/dv CTA (of the one-pass kernel: the rows and
    keys it holds, T rounded up): (kernels, rows, keys)."""
    if d > 80:  # the origin ADM's heads (attention_bwd_wide_f32.cu)
        if t <= (64 if d <= 128 else 48):  # one pass, sized to T
            tk = 16 if t <= 16 else 32 if t <= 32 else 64 if d <= 128 else 48
            return ("attn_wide_bwd_short_kernel",), tk, tk
        rows = (64 if t <= 256 else 32 if t <= 512 else 16) if d <= 128 else \
            32 if t <= 256 else 16
        return ("attn_wide_bwd_dq_kernel", "attn_wide_bwd_dkdv_kernel"), rows, \
            64 if d <= 128 else 32
    keys = 128 if d <= 64 else 64  # attention_row_f32.cuh's dk/dv kernel
    if t <= 256:
        return ("attn_row_bwd_dq_kernel", "attn_row_bwd_dkdv_kernel"), 64, keys
    return ("attn_long_bwd_dq_kernel", "attn_row_bwd_dkdv_kernel"), 32, keys


def _ld(a: torch.Tensor) -> int:
    """Row stride (elements) of an (N, T, H, D) slab; at T = 1 the row is
    the whole sample, whatever stride the size-1 dimension reports."""
    return a.stride(0) if a.shape[1] == 1 else a.stride(1)


def _check_slab(name: str, a: torch.Tensor, ref: torch.Tensor) -> None:
    n, t, h, d = ref.shape
    if a.device != ref.device or a.dtype != ref.dtype or a.shape != ref.shape:
        raise ValueError(f"{name} must be {ref.dtype} {tuple(ref.shape)} on {ref.device}, "
                         f"got {a.dtype} {tuple(a.shape)} on {a.device}")
    ld = _ld(a)
    if (a.stride(3) != 1 or a.stride(2) != d or a.stride(0) != t * ld
            or (ld * a.element_size()) % 16):
        raise ValueError(f"{name} needs (T, H*D) rows with unit stride inside a row and a "
                         f"row stride of whole 16-byte chunks; got strides {a.stride()}")
    if a.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _check_launch(fn: str, q: torch.Tensor, slabs, small_t: bool = True) -> None:
    """Raise unless the kernel ``fn`` takes these (N, T, H, D) CUDA tensors;
    ``small_t``: the kernel is one of the whole-sequence ones (K1, K3)."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    n, t, h, d = q.shape
    if small_t and not _small_shape_ok(q):
        raise ValueError(f"{fn}: T={t} is past the small-T gate")
    if q.dtype not in DTYPES:
        raise ValueError(f"{fn}: dtype {q.dtype} is not one of {DTYPES}")
    dims = HEAD_DIMS + (F32_HEAD_DIMS.get(fn, ()) if q.dtype == torch.float32 else ())
    if d not in dims:
        raise ValueError(f"{fn}: head dim {d} is not one of {dims} for {q.dtype}; "
                         f"shape {tuple(q.shape)}")
    for name, a in slabs:
        _check_slab(f"{fn}: {name}", a, q)


def attention_small(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (N, T, H, D) -> (N, T, H, D), T <= 1024, scale 1/sqrt(D).

    On CUDA: bf16 or f32, D in HEAD_DIMS (f32 also 128 and 256); each of
    q, k, v may be a view whose (T, H*D) rows have any row stride (such as
    the thirds of a fused qkv tensor), and is read in place."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v)
    _check_launch("attention_small", q, (("q", q), ("k", k), ("v", v)))
    n, t, h, d = q.shape
    out = torch.empty((n, t, h, d), dtype=q.dtype, device=q.device)
    rc = load_library().lfm_attention_small(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n, t, h, d,
        _ld(q), _ld(k), _ld(v), h * d, int(q.dtype == torch.float32),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_rc("attention_small", rc)
    ATTENTION_SMALL.add(q.dtype)
    return out


def bwd_stats_scratch(n: int, t: int, h: int, device) -> torch.Tensor:
    """K3's f32 scratch for the row statistics: 3 * N * H * Tp floats, Tp =
    T rounded up to 64 (bf16 takes lse and delta for every row up to Tp, f32
    m, l and delta for every row up to T)."""
    return torch.empty((3 * n * h * (-(-t // 64) * 64),), dtype=torch.float32, device=device)


def _attention_small_bwd_packed(q, k, v, do) -> torch.Tensor:
    """dq, dk, dv stacked in one (N, T, 3, H, D) tensor: its (N, T, 3C) view
    is the gradient of a fused qkv row."""
    if q.device.type == "cpu":
        return torch.stack(reference_attention_bwd(q, k, v, do), dim=2)
    _check_launch("attention_small_bwd", q, (("q", q), ("k", k), ("v", v), ("do", do)))
    n, t, h, d = q.shape
    g = torch.empty((n, t, 3, h, d), dtype=q.dtype, device=q.device)
    stats = bwd_stats_scratch(n, t, h, q.device)
    rc = load_library().lfm_attention_small_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        g[:, :, 0].data_ptr(), g[:, :, 1].data_ptr(), g[:, :, 2].data_ptr(), stats.data_ptr(),
        n, t, h, d, _ld(q), _ld(k), _ld(v), _ld(do), 3 * h * d,
        int(q.dtype == torch.float32), torch.cuda.current_stream(q.device).cuda_stream)
    check_rc("attention_small_bwd", rc)
    ATTENTION_SMALL_BWD.add(q.dtype)
    return g


def attention_small_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``attention_small``; all operands (N, T, H, D), read
    in place as the forward reads them. On CUDA the three are views of one
    (N, T, 3, H, D) buffer."""
    return tuple(_attention_small_bwd_packed(q, k, v, do).unbind(2))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int = 256,
                    block_k: int = 512) -> torch.Tensor:
    """q, k, v: (N, T, H, D) -> (N, T, H, D), any T, scale 1/sqrt(D); keys
    in blocks of ``_pick_block(T, block_k)``, as the JAX kernel takes them.
    ``block_q`` is the JAX signature's: query rows are independent, so it
    changes no value (the kernel takes 64 rows per block).

    On CUDA: bf16 or f32, D in HEAD_DIMS (f32 also 128, with key blocks of
    at most 512, the default: the kernel holds a block's scores on chip,
    ``lfm_flash_f32_max_block``); q, k, v are read in place as
    ``attention_small`` reads them."""
    bk = _pick_block(q.shape[1], block_k)
    if q.device.type == "cpu":
        return reference_flash_attention(q, k, v, block_k=bk)
    _check_launch("flash_attention", q, (("q", q), ("k", k), ("v", v)), small_t=False)
    lib = load_library()
    if q.dtype == torch.float32 and bk > lib.lfm_flash_f32_max_block():
        raise ValueError(f"flash_attention: f32 key blocks of {bk} keys are past the "
                         f"{lib.lfm_flash_f32_max_block()} the kernel holds")
    n, t, h, d = q.shape
    out = torch.empty((n, t, h, d), dtype=q.dtype, device=q.device)
    rc = lib.lfm_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n, t, h, d, bk,
        _ld(q), _ld(k), _ld(v), h * d, int(q.dtype == torch.float32),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_rc("flash_attention", rc)
    FLASH_ATTENTION.add(q.dtype)
    return out


def _forward(q, k, v) -> torch.Tensor:
    """Dispatch as ``_dispatch_attention`` does: the small-T kernel (K1)
    within its gate, the long-T kernel (K4) past it."""
    if _small_shape_ok(q):
        return attention_small(q, k, v)
    return flash_attention(q, k, v)


def _backward_packed(q, k, v, do) -> torch.Tensor:
    """``_fused_attention_bwd``: K3 within the gate; past it the plain
    version's gradient through autograd, on either device."""
    do = do.contiguous()
    if _small_shape_ok(q):
        return _attention_small_bwd_packed(q, k, v, do)
    with torch.enable_grad():
        qkv = [a.detach().requires_grad_(True) for a in (q, k, v)]
        grads = torch.autograd.grad(reference_attention(*qkv), qkv, do)
    return torch.stack(grads, dim=2)


class _FusedAttentionQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads: int):
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return _forward(*split_qkv(qkv, num_heads))

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        g = _backward_packed(*split_qkv(qkv, ctx.num_heads), do)
        return g.reshape(qkv.shape), None


def split_qkv(qkv: torch.Tensor, num_heads: int):
    """Views q, k, v (N, T, H, D) of a fused (N, T, 3C) qkv row."""
    n, t, c3 = qkv.shape
    c = c3 // 3
    return tuple(a.view(n, t, num_heads, c // num_heads) for a in qkv.split(c, dim=-1))


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable attention over (N, T, H, D) tensors (the JAX
    ``fused_attention`` custom_vjp): ``fused_attention_qkv`` over the three
    packed into one qkv row."""
    n, t, h, d = q.shape
    return fused_attention_qkv(torch.cat([a.reshape(n, t, h * d) for a in (q, k, v)], dim=-1), h)


def fused_attention_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``fused_attention`` over the thirds of a fused (N, T, 3C) qkv row,
    read in place. Its backward writes dq, dk, dv into one (N, T, 3C)
    gradient, so the qkv Linear gets it with no concatenation."""
    return _FusedAttentionQKV.apply(qkv, num_heads)
