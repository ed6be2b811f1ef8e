"""Differentiable fused DiT block: the CUDA kernels K5 and their plain versions.

Port of lfm_tpu/kernels/dit_block_train.py. Its three pallas_calls each
become one entry point of ``csrc/dit_block_train.cu``:

* ``block_train_fwd`` (`_block_fwd_call`): K2's math (kernels/dit_block.py)
  that also writes the residual streams the backward reads, each rounded to
  bf16 from the f32 value the forward itself goes on with: ``full`` writes
  out, x1, h2, pr, qkv, ao, u; ``slim`` out, h2, pr, qkv.
* ``mlp_bwd`` (`_mlp_bwd_call`): dx1, the MLP half's (shift, scale, gate)
  cotangents and dW1, db1, dW2, db2, recomputing LN2 and GELU from the
  streams.
* ``attn_bwd`` (`_attn_bwd_call`): dx, the MSA half's cotangents and dWqkv,
  dbqkv, dWproj, dbproj, recomputing LN1 and each head's softmax.

``make_fused_block_train`` wraps them in a ``torch.autograd.Function`` with
the JAX modes: the forward's streams (``slim`` only without ``pallas_bwd``)
and the backward, either ``hybrid_bwd`` (the port of ``_jnp_bwd``, the
default: plain tensor products around the K3 attention core, and K1 to
recompute ao in ``slim``) or the two backward kernels (``pallas_bwd``). The
modes round at different points on purpose; each mirrors its JAX mode.

Weights are in ``torch.nn.Linear`` layout (out, in), as K2's are, so the
weight gradients come back in that layout (JAX returns flax's (in, out)).
mod is (N, 6C) in the order shift/scale/gate (msa), shift/scale/gate (mlp);
dmod comes back in the same order. On a CPU tensor each wrapper computes its
plain version; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from lfm_tpu_torch.kernels._build import LaunchCounter, check_rc, load_library
from lfm_tpu_torch.kernels.dit_block import check_operand, reference_block_parts
from lfm_tpu_torch.kernels.flash_attention import (HEAD_DIMS, _attention_small_bwd_packed,
                                                   attention_small, bwd_stats_scratch,
                                                   reference_attention_bwd, split_qkv)

BLOCK_TRAIN_FWD = LaunchCounter()
MLP_BWD = LaunchCounter()
ATTN_BWD = LaunchCounter()
SAVE_STREAMS = ("full", "slim")
# the widest C whose rows the LayerNorm backward keeps in registers
# (dit_block_train.cu's LN_BWD_MAX_C)
MAX_C = 4096
_LN_EPS = 1e-6
_GELU_A = math.sqrt(2.0 / math.pi)
_GELU_K = 0.044715
_BF = torch.bfloat16


def _ln_fwd_parts(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normalized, rsqrt) of the no-affine LayerNorm over the last axis,
    var = E[x^2] - E[x]^2."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.square().mean(dim=-1, keepdim=True) - mu.square()
    r = torch.rsqrt(var + _LN_EPS)
    return (x - mu) * r, r


def _ln_bwd(dn: torch.Tensor, n: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Cotangent of x for y = LN(x), given dy = dn, y = n, rsqrt = r."""
    return r * (dn - dn.mean(dim=-1, keepdim=True) - n * (dn * n).mean(dim=-1, keepdim=True))


def _gelu_tanh(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    t = torch.tanh(_GELU_A * (u + _GELU_K * u * u * u))
    return 0.5 * u * (1.0 + t), t


def _gelu_tanh_grad(u: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """d gelu(u) / du given t = tanh(a (u + k u^3))."""
    inner = _GELU_A * (1.0 + 3.0 * _GELU_K * u * u)
    return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * inner


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 2-D operands, accumulated and returned in f32 (an einsum
    with ``preferred_element_type=f32``). Outside any kernel, as in JAX's
    ``_jnp_bwd``: cuBLAS on the card, f32 on the CPU."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _mod_vectors(mod: torch.Tensor, n: int, c: int):
    mod3 = mod.reshape(n, 6, c).float()
    return tuple(mod3[:, i, None, :] for i in range(6))


# --------------------------------------------------------------------------
# plain versions, at each TPU kernel's rounding points
# --------------------------------------------------------------------------

def reference_block_fwd_streams(x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2, *,
                                num_heads: int, save_streams: str = "full"
                                ) -> Tuple[torch.Tensor, ...]:
    """Plain version of ``_fwd_kernel``: ``full`` returns (out, x1, h2, pr,
    qkv, ao, u), ``slim`` (out, h2, pr, qkv), every stream bf16, of shape
    (N, T, C), qkv (N, T, 3C), u (N, T, hidden)."""
    p = reference_block_parts(x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2,
                              num_heads=num_heads)
    out, h2, pr, qkv = p["out"], p["h2"].to(_BF), p["pr"].to(_BF), p["qkv"]
    if save_streams == "slim":
        return out, h2, pr, qkv
    return out, p["x1"].to(_BF), h2, pr, qkv, p["ao"], p["u"].to(_BF)


def reference_mlp_bwd(x1, mod, h2, u, w1, w2, dy):
    """Plain version of ``_mlp_bwd_kernel``: (dx1 bf16, dmod (N, 3, C) f32 as
    shift/scale/gate of the MLP half, dW1 (hidden, C), db1, dW2 (C, hidden),
    db2, all f32 and summed over every row). dy enters in bf16; dh2 and du
    stay f32 for the bias and gate sums and round to bf16 for the products."""
    n, t, c = x1.shape
    rows = n * t
    sh, sc, g = _mod_vectors(mod, n, c)[3:]
    x1f, dyf = x1.float(), dy.float()
    n2, r2 = _ln_fwd_parts(x1f)
    h2b = (n2 * (1.0 + sc) + sh).to(_BF).reshape(rows, c)
    uf = u.float().reshape(rows, -1)
    gl, tanh_u = _gelu_tanh(uf)
    gb = gl.to(_BF)

    dg = (dyf * h2.float()).sum(dim=1)
    dh2 = (dyf * g).reshape(rows, c)
    dh2b = dh2.to(_BF)
    dgb = _mm_f32(dh2b, w2)  # (rows, hidden)
    dw2 = _mm_f32(dh2b.t(), gb)  # (C, hidden)
    db2 = dh2.sum(dim=0)
    du = dgb * _gelu_tanh_grad(uf, tanh_u)
    dub = du.to(_BF)
    dh = _mm_f32(dub, w1).reshape(n, t, c)  # (rows, C)
    dw1 = _mm_f32(dub.t(), h2b)  # (hidden, C)
    db1 = du.sum(dim=0)
    dsc = (dh * n2).sum(dim=1)
    dsh = dh.sum(dim=1)
    dx1 = (dyf + _ln_bwd(dh * (1.0 + sc), n2, r2)).to(_BF)
    return dx1, torch.stack([dsh, dsc, dg], dim=1), dw1, db1, dw2, db2


def reference_attn_bwd(x, mod, pr, qkv, ao, wqkv, wproj, dx1, *, num_heads: int):
    """Plain version of ``_attn_bwd_kernel``: (dx bf16, dmod (N, 3, C) f32 as
    shift/scale/gate of the MSA half, dWqkv (3C, C), dbqkv, dWproj (C, C),
    dbproj, all f32). Each head's probs are recomputed from qkv; the
    attention core is K3's arithmetic (``reference_attention_bwd``) on
    do = bf16(dpr Wproj)."""
    n, t, c = x.shape
    rows = n * t
    sh, sc, g = _mod_vectors(mod, n, c)[:3]
    xf, dx1f = x.float(), dx1.float()
    n1, r1 = _ln_fwd_parts(xf)
    hb = (n1 * (1.0 + sc) + sh).to(_BF).reshape(rows, c)

    dg = (dx1f * pr.float()).sum(dim=1)
    dpr = (dx1f * g).reshape(rows, c)
    dprb = dpr.to(_BF)
    dao = _mm_f32(dprb, wproj).to(_BF)
    dwproj = _mm_f32(dprb.t(), ao.reshape(rows, c))
    dbproj = dpr.sum(dim=0)

    q, k, v = split_qkv(qkv, num_heads)
    do = dao.reshape(q.shape)
    dqkv = torch.stack(reference_attention_bwd(q, k, v, do), dim=2).reshape(rows, 3 * c)
    dhb = _mm_f32(dqkv, wqkv).reshape(n, t, c)
    dwqkv = _mm_f32(dqkv.t(), hb)
    dbqkv = dqkv.float().sum(dim=0)
    dsc = (dhb * n1).sum(dim=1)
    dsh = dhb.sum(dim=1)
    dx = (dx1f + _ln_bwd(dhb * (1.0 + sc), n1, r1)).to(_BF)
    return dx, torch.stack([dsh, dsc, dg], dim=1), dwqkv, dbqkv, dwproj, dbproj


def hybrid_bwd(num_heads: int, saved: Tuple[torch.Tensor, ...], dy: torch.Tensor):
    """``_jnp_bwd``: the backward in plain tensor products over the streams,
    with the attention core through K3 (``attention_small_bwd``). ``saved``
    is (x, mod, x1, h2, pr, qkv, ao, u, wqkv, wproj, w1, w2) after ``full``,
    or (x, mod, h2, pr, qkv, wqkv, wproj, w1, b1, w2) after ``slim``, which
    rebuilds x1 = x + g pr, recomputes u in f32 (not rounded) and ao through
    K1 (``attention_small``). dh2 and dpr round to bf16 before every use;
    dx1 stays f32. Returns the 10 cotangents in bf16: dx, dmod (N, 6C),
    dWqkv, dbqkv, dWproj, dbproj, dW1, db1, dW2, db2."""
    if len(saved) == 10:
        x, mod, h2, pr, qkv, wqkv, wproj, w1, b1, w2 = saved
        x1 = ao = u = None
    else:
        x, mod, x1, h2, pr, qkv, ao, u, wqkv, wproj, w1, w2 = saved
        b1 = None
    n, t, c = x.shape
    rows = n * t
    sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = _mod_vectors(mod, n, c)
    dyf = dy.float()
    xf = x.float()
    x1f = xf + g_msa * pr.float() if x1 is None else x1.float()

    # MLP half
    n2, r2 = _ln_fwd_parts(x1f)
    h2b = (n2 * (1.0 + sc_mlp) + sh_mlp).to(_BF).reshape(rows, c)
    uf = (_mm_f32(h2b, w1.t()) + b1.float()) if u is None else u.float().reshape(rows, -1)
    gl, tanh_u = _gelu_tanh(uf)
    gb = gl.to(_BF)
    dg_mlp = (dyf * h2.float()).sum(dim=1)
    dh2 = (dyf * g_mlp).to(_BF).reshape(rows, c)
    dgb = _mm_f32(dh2, w2)
    dw2 = _mm_f32(dh2.t(), gb)
    db2 = dh2.float().sum(dim=0)
    du = (dgb * _gelu_tanh_grad(uf, tanh_u)).to(_BF)
    dh2b = _mm_f32(du, w1).reshape(n, t, c)
    dw1 = _mm_f32(du.t(), h2b)
    db1 = du.float().sum(dim=0)
    dsc_mlp = (dh2b * n2).sum(dim=1)
    dsh_mlp = dh2b.sum(dim=1)
    dx1 = dyf + _ln_bwd(dh2b * (1.0 + sc_mlp), n2, r2)

    # attention half
    n1, r1 = _ln_fwd_parts(xf)
    hb = (n1 * (1.0 + sc_msa) + sh_msa).to(_BF).reshape(rows, c)
    dg_msa = (dx1 * pr.float()).sum(dim=1)
    dpr = (dx1 * g_msa).to(_BF).reshape(rows, c)
    dao = _mm_f32(dpr, wproj)
    dbproj = dpr.float().sum(dim=0)
    q, k, v = split_qkv(qkv, num_heads)
    if ao is None:
        ao = attention_small(q, k, v).reshape(n, t, c)
    do = dao.to(_BF).reshape(q.shape)
    dqkv = _attention_small_bwd_packed(q, k, v, do).reshape(rows, 3 * c)  # K3
    dwproj = _mm_f32(dpr.t(), ao.reshape(rows, c).to(_BF))
    dhb = _mm_f32(dqkv, wqkv).reshape(n, t, c)
    dwqkv = _mm_f32(dqkv.t(), hb)
    dbqkv = dqkv.float().sum(dim=0)
    dsc_msa = (dhb * n1).sum(dim=1)
    dsh_msa = dhb.sum(dim=1)
    dx = dx1 + _ln_bwd(dhb * (1.0 + sc_msa), n1, r1)

    dmod = torch.stack([dsh_msa, dsc_msa, dg_msa, dsh_mlp, dsc_mlp, dg_mlp], dim=1)
    return tuple(a.to(_BF) for a in (dx, dmod.reshape(n, 6 * c), dwqkv, dbqkv, dwproj, dbproj,
                                     dw1, db1, dw2, db2))


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------

def _check_block(fn: str, x: torch.Tensor, hidden: int, num_heads: int = 0) -> None:
    """Raise unless the K5 kernels take this (N, T, C) CUDA tensor (and,
    given ``num_heads``, its head dim)."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    n, t, c = x.shape
    if c % 128 or c > MAX_C or hidden % 128 or t > 1024 or (n * t) % 32:
        raise ValueError(f"{fn}: unsupported shape N={n} T={t} C={c} hidden={hidden} (C and "
                         f"hidden multiples of 128, C <= {MAX_C}, T <= 1024, N*T a multiple "
                         f"of 32)")
    if num_heads and (c % num_heads or c // num_heads not in HEAD_DIMS):
        raise ValueError(f"{fn}: C={c} with {num_heads} heads: the head dim must be one of "
                         f"{HEAD_DIMS}")


def _check_all(fn: str, dev, operands) -> None:
    for name, a, shape in operands:
        check_operand(fn, name, a, shape, dev)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def block_train_fwd(x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2, *, num_heads: int,
                    save_streams: str = "full") -> Tuple[torch.Tensor, ...]:
    """The forward and its residual streams, as ``reference_block_fwd_streams``
    returns them. On CUDA: all bf16 and contiguous, C % 128 == 0, hidden %
    128 == 0, C <= MAX_C, head dim C / num_heads in HEAD_DIMS, T <= 1024, N*T % 32
    == 0."""
    if save_streams not in SAVE_STREAMS:
        raise ValueError(f"save_streams must be one of {SAVE_STREAMS}, got {save_streams!r}")
    if x.device.type == "cpu":
        return reference_block_fwd_streams(x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2,
                                           num_heads=num_heads, save_streams=save_streams)
    fn = "block_train_fwd"
    hidden = w1.shape[0]
    _check_block(fn, x, hidden, num_heads)
    n, t, c = x.shape
    dev = x.device
    _check_all(fn, dev, (("x", x, (n, t, c)), ("mod", mod, (n, 6 * c)),
                         ("wqkv", wqkv, (3 * c, c)), ("bqkv", bqkv, (3 * c,)),
                         ("wproj", wproj, (c, c)), ("bproj", bproj, (c,)),
                         ("w1", w1, (hidden, c)), ("b1", b1, (hidden,)),
                         ("w2", w2, (c, hidden)), ("b2", b2, (c,))))
    full = save_streams == "full"

    def act(width, dtype=_BF):
        return torch.empty((n, t, width), dtype=dtype, device=dev)

    out, h2, pr, qkv, ao = act(c), act(c), act(c), act(3 * c), act(c)
    x1s, us = (act(c), act(hidden)) if full else (None, None)
    h, x1f, g = act(c), act(c, torch.float32), act(hidden)
    ptr = [a.data_ptr() if a is not None else None for a in (
        x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2, out, x1s, h2, pr, qkv, ao, us, h, x1f, g)]
    rc = load_library().lfm_dit_block_train_fwd(*ptr, n, t, c, hidden, num_heads, _stream(dev))
    check_rc(fn, rc)
    BLOCK_TRAIN_FWD.count += 1
    if full:
        return out, x1s, h2, pr, qkv, ao, us
    return out, h2, pr, qkv


def mlp_bwd(x1, mod, h2, u, w1, w2, dy):
    """The MLP half's backward, as ``reference_mlp_bwd`` returns it. On CUDA:
    bf16 and contiguous operands; the shapes ``block_train_fwd`` takes."""
    if x1.device.type == "cpu":
        return reference_mlp_bwd(x1, mod, h2, u, w1, w2, dy)
    fn = "mlp_bwd"
    hidden = w1.shape[0]
    n, t, c = x1.shape
    _check_block(fn, x1, hidden)
    dev = x1.device
    _check_all(fn, dev, (("x1", x1, (n, t, c)), ("mod", mod, (n, 6 * c)), ("h2", h2, (n, t, c)),
                         ("u", u, (n, t, hidden)), ("w1", w1, (hidden, c)),
                         ("w2", w2, (c, hidden)), ("dy", dy, (n, t, c))))
    rows = n * t
    f32 = torch.float32
    dx1 = torch.empty((n, t, c), dtype=_BF, device=dev)
    dmod = torch.empty((n, 3, c), dtype=f32, device=dev)
    dw1 = torch.empty((hidden, c), dtype=f32, device=dev)
    db1 = torch.empty((hidden,), dtype=f32, device=dev)
    dw2 = torch.empty((c, hidden), dtype=f32, device=dev)
    db2 = torch.empty((c,), dtype=f32, device=dev)
    h2b, dh2b = (torch.empty((rows, c), dtype=_BF, device=dev) for _ in range(2))
    gb, du = (torch.empty((rows, hidden), dtype=_BF, device=dev) for _ in range(2))
    dh = torch.empty((rows, c), dtype=f32, device=dev)
    stats = torch.empty((rows, 2), dtype=f32, device=dev)
    part = torch.empty((max(n * c, -(-rows // 128) * hidden),), dtype=f32, device=dev)
    ptr = [a.data_ptr() for a in (x1, mod, h2, u, w1, w2, dy, dx1, dmod, dw1, db1, dw2, db2,
                                  h2b, dh2b, gb, du, dh, stats, part)]
    rc = load_library().lfm_dit_block_train_mlp_bwd(*ptr, n, t, c, hidden, _stream(dev))
    check_rc(fn, rc)
    MLP_BWD.count += 1
    return dx1, dmod, dw1, db1, dw2, db2


def attn_bwd(x, mod, pr, qkv, ao, wqkv, wproj, dx1, *, num_heads: int):
    """The attention half's backward, as ``reference_attn_bwd`` returns it.
    On CUDA: bf16 and contiguous operands; the shapes ``block_train_fwd``
    takes."""
    if x.device.type == "cpu":
        return reference_attn_bwd(x, mod, pr, qkv, ao, wqkv, wproj, dx1, num_heads=num_heads)
    fn = "attn_bwd"
    n, t, c = x.shape
    _check_block(fn, x, 128, num_heads)
    dev = x.device
    _check_all(fn, dev, (("x", x, (n, t, c)), ("mod", mod, (n, 6 * c)), ("pr", pr, (n, t, c)),
                         ("qkv", qkv, (n, t, 3 * c)), ("ao", ao, (n, t, c)),
                         ("wqkv", wqkv, (3 * c, c)), ("wproj", wproj, (c, c)),
                         ("dx1", dx1, (n, t, c))))
    rows = n * t
    f32 = torch.float32
    dx = torch.empty((n, t, c), dtype=_BF, device=dev)
    dmod = torch.empty((n, 3, c), dtype=f32, device=dev)
    dwqkv = torch.empty((3 * c, c), dtype=f32, device=dev)
    dbqkv = torch.empty((3 * c,), dtype=f32, device=dev)
    dwproj = torch.empty((c, c), dtype=f32, device=dev)
    dbproj = torch.empty((c,), dtype=f32, device=dev)
    hb, dpr, dao = (torch.empty((rows, c), dtype=_BF, device=dev) for _ in range(3))
    dqkv = torch.empty((rows, 3 * c), dtype=_BF, device=dev)
    dhb = torch.empty((rows, c), dtype=f32, device=dev)
    stats = torch.empty((rows, 2), dtype=f32, device=dev)
    astats = bwd_stats_scratch(n, t, num_heads, dev)
    part = torch.empty((n * 3 * c,), dtype=f32, device=dev)
    ptr = [a.data_ptr() for a in (x, mod, pr, qkv, ao, wqkv, wproj, dx1, dx, dmod, dwqkv, dbqkv,
                                  dwproj, dbproj, hb, dpr, dao, dqkv, dhb, stats, astats, part)]
    rc = load_library().lfm_dit_block_train_attn_bwd(*ptr, n, t, c, num_heads, _stream(dev))
    check_rc(fn, rc)
    ATTN_BWD.count += 1
    return dx, dmod, dwqkv, dbqkv, dwproj, dbproj


# --------------------------------------------------------------------------
# the autograd Function
# --------------------------------------------------------------------------

def _check_cell(name: str, n: int, cell: int) -> None:
    """The JAX grid is n // cell cells of ``cell`` samples; it takes no
    other batch."""
    if cell <= 0 or n % cell:
        raise ValueError(f"make_fused_block_train: batch {n} is not a whole number of "
                         f"{name} cells of {cell} samples")


class _FusedBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg: Dict, x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2):
        heads, mode = cfg["num_heads"], cfg["mode"]
        _check_cell("forward", x.shape[0], cfg["fwd_cell"])
        if cfg["pallas_bwd"]:
            _check_cell("backward", x.shape[0], cfg["bwd_cell"])
        streams = block_train_fwd(x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2,
                                  num_heads=heads, save_streams=mode)
        if mode == "slim":
            out, h2, pr, qkv = streams
            ctx.save_for_backward(x, mod, h2, pr, qkv, wqkv, wproj, w1, b1, w2)
        else:
            out, x1, h2, pr, qkv, ao, u = streams
            ctx.save_for_backward(x, mod, x1, h2, pr, qkv, ao, u, wqkv, wproj, w1, w2)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, dy):
        cfg = ctx.cfg
        saved = ctx.saved_tensors
        if not cfg["pallas_bwd"]:
            return (None,) + hybrid_bwd(cfg["num_heads"], saved, dy)
        x, mod, x1, h2, pr, qkv, ao, u, wqkv, wproj, w1, w2 = saved
        dx1, dmod_mlp, dw1, db1, dw2, db2 = mlp_bwd(x1, mod, h2, u, w1, w2,
                                                    dy.to(_BF).contiguous())
        dx, dmod_msa, dwqkv, dbqkv, dwproj, dbproj = attn_bwd(
            x, mod, pr, qkv, ao, wqkv, wproj, dx1, num_heads=cfg["num_heads"])
        n, _, c = x.shape
        dmod = torch.cat([dmod_msa, dmod_mlp], dim=1).reshape(n, 6 * c)
        return (None, dx) + tuple(a.to(_BF) for a in (dmod, dwqkv, dbqkv, dwproj, dbproj,
                                                       dw1, db1, dw2, db2))


def make_fused_block_train(num_heads: int, fwd_cell: int, bwd_cell: int = 0,
                           pallas_bwd: bool = False, save_streams: str = "full"
                           ) -> Callable[..., torch.Tensor]:
    """The differentiable fused block ``block(x, mod, wqkv, bqkv, wproj,
    bproj, w1, b1, w2, b2) -> out``: all bf16, mod (N, 6C); the cotangents
    come back bf16 (the caller's f32 -> bf16 cast turns them into the f32
    gradients the optimizer reads, as JAX's cast transpose does).

    ``fwd_cell`` and ``bwd_cell`` keep the JAX signature so that call sites
    read alike: the TPU kernels run ``N / cell`` grid cells of ``cell``
    samples, and a batch that is not a whole number of cells raises here too
    (``bwd_cell`` only with ``pallas_bwd``). Otherwise they change nothing:
    the CUDA kernels sum the weight gradients over all rows in their own f32
    order, where the TPU kernels add per-cell sums. ``save_streams="slim"``
    applies only without ``pallas_bwd``, as in JAX."""
    if save_streams not in SAVE_STREAMS:
        raise ValueError(f"save_streams must be one of {SAVE_STREAMS}, got {save_streams!r}")
    cfg = {"num_heads": num_heads, "fwd_cell": fwd_cell, "bwd_cell": bwd_cell,
           "pallas_bwd": pallas_bwd,
           "mode": "slim" if save_streams == "slim" and not pallas_bwd else "full"}

    def block(x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2):
        return _FusedBlockTrain.apply(cfg, x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2)

    return block
