"""The wgmma + TMA GEMM of K2, K5 and P1-bf16 (``csrc/gemm_sm90.cuh``) in its
three layouts, and their plain versions.

NT, ``out (M, N) = epilogue(a (M, K) . w (N, K)^T)``: the products of
lfm_tpu/kernels/dit_block.py::_dit_block_kernel (and of K5's `_fwd_kernel`)
with their epilogues at the same rounding points: the product of bf16
operands summed in f32, then in f32

- ``bias``       out = value + bias
- ``store``      out = value
- ``gelu``       out = gelu_tanh(value + bias)
- ``gelu_aux``   the same, and aux = bf16(value + bias)
- ``gated``      out = f32(resid) + f32(mod[m // tokens, gate * N + n]) * (value + bias)
- ``gated_aux``  the same, aux = bf16(value + bias) and aux2 = bf16(out)

with a null bias adding nothing and out rounded once to ``out_dtype``.

NN, ``a (M, K) . b (K, N)``, and TN, ``a (K, M)^T . b (K, N)``: the four
products of K5's MLP backward (`_mlp_bwd_kernel`) and the four of its
attention backward (`_attn_bwd_kernel`), f32 out (``store``; NN also into
bf16, K5 attn's do), or for NN ``dgelu``: du = value * gelu_tanh'(f32(u))
into bf16, the f32 sums of du over each 128-row tile (``part``, summed in
the kernel's fixed order) and gb = bf16(gelu_tanh(f32(u))) from the same
tanh.

The blocks call the kernel from C (``csrc/dit_block.cu``,
``csrc/dit_block_train.cu``, ``csrc/int8_gemm.cu``); these wrappers give it
calls of its own for the tests, ``chip_smoke.py`` and
``tools/bench_block.py``. On a CPU tensor each computes its plain version;
on a CUDA tensor it launches the kernel or raises. Their checks do not
depend on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lfm_tpu_torch.kernels._build import LaunchCounter, check_rc, load_library
from lfm_tpu_torch.kernels.dit_block_train import _gelu_tanh, _gelu_tanh_grad

GEMM = LaunchCounter()
# the C epilogue codes (csrc/gemm.cuh): EPILOGUES[code]
EPILOGUES = ("bias", "gelu", "gated", "gelu_aux", "gated_aux", "store")
TILE_N, TILE_K = 128, 64
TILE_M = 128  # rows of a tile; a "dgelu" part row sums one tile's rows
LAYOUTS = {"nn": 1, "tn": 2}  # csrc/gemm.cuh's LAYOUT_NN, LAYOUT_TN
BWD_EPILOGUES = {"store": 5, "dgelu": 6}  # EPI_STORE, EPI_DGELU
SMS = 132  # streaming multiprocessors of an H100 SXM
_BF, _F32 = torch.bfloat16, torch.float32

Outputs = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def _fail(msg: str) -> None:
    raise ValueError(f"gemm: {msg}")


def _check(a, w, bias, epilogue, resid, mod, gate, tokens, out_dtype, aux, aux2) -> None:
    """Raise on what the kernel does not take; the same on every device."""
    if epilogue not in EPILOGUES:
        _fail(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        _fail(f"a must be (M, K) and w (N, K), got {tuple(a.shape)} and {tuple(w.shape)}")
    m, k = a.shape
    n = w.shape[0]
    if n % TILE_N or k % TILE_K or m < 1:
        _fail(f"the kernel needs N % {TILE_N} == 0 and K % {TILE_K} == 0, got N={n} K={k} M={m}")
    operands = [("a", a, _BF, (m, k)), ("w", w, _BF, (n, k))]
    if bias is not None:
        operands.append(("bias", bias, _BF, (n,)))
    gated = epilogue.startswith("gated")
    if gated:
        if resid is None or mod is None:
            _fail(f"{epilogue} needs resid and mod")
        if tokens < 1 or m % tokens or not 0 <= gate < 6:
            _fail(f"{epilogue} needs M % tokens == 0 and gate in 0..5, got M={m} "
                  f"tokens={tokens} gate={gate}")
        # the built instances: a bf16 resid into f32, an f32 resid into bf16
        want = _F32 if resid.dtype == _BF else _BF
        if resid.dtype not in (_BF, _F32) or out_dtype != want:
            _fail(f"{epilogue} takes a bf16 resid into float32 or a float32 resid into "
                  f"bfloat16, got {resid.dtype} into {out_dtype}")
        operands += [("resid", resid, resid.dtype, (m, n)), ("mod", mod, _BF, (m // tokens, 6 * n))]
    else:
        if resid is not None or mod is not None:
            _fail(f"{epilogue} takes no resid or mod")
        if out_dtype != _BF:
            _fail(f"{epilogue} writes bfloat16, got {out_dtype}")
    if aux and not epilogue.endswith("_aux"):
        _fail(f"{epilogue} writes no aux")
    if aux2 and epilogue != "gated_aux":
        _fail(f"{epilogue} writes no aux2")
    for name, t, dtype, shape in operands:
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != a.device:
            _fail(f"{name} must be {dtype} {shape} on {a.device}, got {t.dtype} "
                  f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            _fail(f"{name} must be contiguous")


def reference_gemm(a, w, bias=None, *, epilogue: str = "bias", resid=None, mod=None,
                   gate: int = 0, tokens: int = 1, out_dtype=_BF, aux: bool = False,
                   aux2: bool = False) -> Outputs:
    """Plain version: (out, aux, aux2), aux and aux2 None unless asked for."""
    value = a.float() @ w.float().T
    if bias is not None and epilogue != "store":
        value = value + bias.float()
    aux_out = value.to(_BF) if aux else None
    aux2_out = None
    if epilogue.startswith("gelu"):
        value = F.gelu(value, approximate="tanh")
    elif epilogue.startswith("gated"):
        m, n = value.shape
        g = mod.float().view(m // tokens, 6, n)[:, gate, None, :]
        value = (resid.float().view(m // tokens, tokens, n) + g
                 * value.view(m // tokens, tokens, n)).view(m, n)
        aux2_out = value.to(_BF) if aux2 else None
    return value.to(out_dtype), aux_out, aux2_out


def gemm(a, w, bias=None, *, epilogue: str = "bias", resid=None, mod=None, gate: int = 0,
         tokens: int = 1, out_dtype=_BF, aux: bool = False, aux2: bool = False) -> Outputs:
    """out (M, N) = epilogue(a (M, K) . w (N, K)^T), with the module's
    epilogues; returns (out, aux, aux2), aux (aux2) a bf16 (M, N) stream
    when asked for, else None. a, w, bias, mod bf16 and contiguous; resid
    bf16 into an f32 out or f32 into a bf16 out (the gated epilogues);
    N % 128 == 0, K % 64 == 0."""
    _check(a, w, bias, epilogue, resid, mod, gate, tokens, out_dtype, aux, aux2)
    if a.device.type == "cpu":
        return reference_gemm(a, w, bias, epilogue=epilogue, resid=resid, mod=mod, gate=gate,
                              tokens=tokens, out_dtype=out_dtype, aux=aux, aux2=aux2)
    if a.device.type != "cuda":
        _fail(f"unsupported device {a.device}")
    m, n, k = a.shape[0], w.shape[0], a.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    aux_out = torch.empty((m, n), dtype=_BF, device=a.device) if aux else None
    aux2_out = torch.empty((m, n), dtype=_BF, device=a.device) if aux2 else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = load_library().lfm_gemm(
        a.data_ptr(), w.data_ptr(), ptr(bias), out.data_ptr(), ptr(resid), ptr(mod),
        ptr(aux_out), ptr(aux2_out), EPILOGUES.index(epilogue), int(out_dtype == _F32),
        int(resid is not None and resid.dtype == _F32), gate, tokens, m, n, k,
        torch.cuda.current_stream(a.device).cuda_stream)
    check_rc("gemm", rc)
    GEMM.count += 1
    return out, aux_out, aux2_out



def gemm_tile(m: int, n: int, sms: int = SMS) -> Tuple[int, int]:
    """(tile width, CTAs) of the kernel for an (M, N) output on ``sms`` SMs,
    in any layout (``tile_n`` and ``launch_bn``, csrc/gemm_sm90.cuh): 256
    wide unless N % 256 != 0 or 128-wide tiles end the busiest SM's work
    more than 1/8 sooner; one persistent CTA an SM, at most one a tile."""
    m_tiles = -(-m // TILE_M)
    if n % 256:
        bn = 128
    else:
        def span(bn):
            return -(-(m_tiles * (n // bn)) // sms) * bn
        bn = 128 if 8 * span(128) < 7 * span(256) else 256
    return bn, min(m_tiles * (n // bn), sms)


def _check_bwd(layout: str, a, b, epilogue: str, u, out_dtype=_F32) -> Tuple[int, int, int]:
    """Raise on what the NN / TN kernel does not take; (M, N, K)."""
    if layout not in LAYOUTS:
        _fail(f"layout must be one of {tuple(LAYOUTS)}, got {layout!r}")
    if epilogue not in BWD_EPILOGUES or (epilogue == "dgelu" and layout != "nn"):
        _fail(f"{layout} takes epilogue 'store'{' or dgelu' if layout == 'nn' else ''}, "
              f"got {epilogue!r}")
    # the built instances: store into f32 (NN, TN) or bf16 (NN)
    if epilogue == "store" and out_dtype not in ((_F32, _BF) if layout == "nn" else (_F32,)):
        _fail(f"{layout} store writes {'float32 or bfloat16' if layout == 'nn' else 'float32'}, "
              f"got {out_dtype}")
    a_dims = "(M, K)" if layout == "nn" else "(K, M)"
    if a.dim() != 2 or b.dim() != 2 or a.shape[layout == "nn"] != b.shape[0]:
        _fail(f"a must be {a_dims} and b (K, N), got {tuple(a.shape)} and {tuple(b.shape)}")
    m, k = a.shape if layout == "nn" else a.shape[::-1]
    n = b.shape[1]
    if m < 1 or n % TILE_N or k < 8 or k % 8 or (layout == "tn" and m % 8):
        _fail(f"the {layout} kernel needs N % {TILE_N} == 0, K % 8 == 0"
              f"{' and M % 8 == 0' if layout == 'tn' else ''}, got M={m} N={n} K={k}")
    operands = [("a", a, tuple(a.shape)), ("b", b, (k, n))]
    if epilogue == "dgelu":
        if u is None:
            _fail("dgelu needs u")
        operands.append(("u", u, (m, n)))
    elif u is not None:
        _fail("store takes no u")
    for name, t, shape in operands:
        if t.dtype != _BF or tuple(t.shape) != shape or t.device != a.device:
            _fail(f"{name} must be {_BF} {shape} on {a.device}, got {t.dtype} "
                  f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            _fail(f"{name} must be contiguous")
    return m, n, k


def dgelu_parts(du: torch.Tensor) -> torch.Tensor:
    """(ceil(M / 128), N): the f32 sum of du (M, N) over each 128-row tile
    (plain order)."""
    m, n = du.shape
    rows = -(-m // TILE_M) * TILE_M
    padded = torch.nn.functional.pad(du, (0, 0, 0, rows - m))
    return padded.view(rows // TILE_M, TILE_M, n).sum(dim=1)


def reference_gemm_nn(a, b, *, epilogue: str = "store", u=None, out_dtype=_F32):
    """Plain version of ``gemm_nn``: the f32 product; ``store`` returns it
    rounded once to ``out_dtype``, ``dgelu`` (bf16(du), part,
    bf16(gelu(u))) with du = value * gelu_tanh'(f32(u)) in f32."""
    value = a.float() @ b.float()
    if epilogue != "dgelu":
        return value.to(out_dtype)
    gl, t = _gelu_tanh(u.float())
    du = value * _gelu_tanh_grad(u.float(), t)
    return du.to(_BF), dgelu_parts(du), gl.to(_BF)


def reference_gemm_tn(a, b) -> torch.Tensor:
    """Plain version of ``gemm_tn``: a^T b of bf16 operands in f32."""
    return a.float().T @ b.float()


def _gemm_bwd(layout: str, a, b, epilogue: str, u, out_dtype=_F32):
    m, n, k = _check_bwd(layout, a, b, epilogue, u, out_dtype)
    if a.device.type == "cpu":
        if layout == "tn":
            return reference_gemm_tn(a, b)
        return reference_gemm_nn(a, b, epilogue=epilogue, u=u, out_dtype=out_dtype)
    if a.device.type != "cuda":
        _fail(f"unsupported device {a.device}")
    dgelu = epilogue == "dgelu"
    out = torch.empty((m, n), dtype=_BF if dgelu else out_dtype, device=a.device)
    part = torch.empty((-(-m // TILE_M), n), dtype=_F32, device=a.device) if dgelu else None
    gb = torch.empty((m, n), dtype=_BF, device=a.device) if dgelu else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = load_library().lfm_gemm_bwd(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), ptr(u), ptr(part), ptr(gb), LAYOUTS[layout],
        BWD_EPILOGUES[epilogue], int(out.dtype == _F32), m, n, k,
        torch.cuda.current_stream(a.device).cuda_stream)
    check_rc(f"gemm_{layout}", rc)
    GEMM.count += 1
    return (out, part, gb) if dgelu else out


def gemm_nn(a, b, *, epilogue: str = "store", u=None, out_dtype=_F32):
    """a (M, K) . b (K, N), bf16 and contiguous: ``store`` returns the (M,
    N) product rounded once to ``out_dtype`` (float32 or bfloat16);
    ``dgelu`` (du, part, gb): du = bf16(value * gelu_tanh'(u)) with u (M, N)
    bf16, part (ceil(M / 128), N) f32 the sums of the f32 du over each
    128-row tile, gb = bf16(gelu_tanh(u)). N % 128 == 0, K % 8 == 0."""
    return _gemm_bwd("nn", a, b, epilogue, u, out_dtype)


def gemm_tn(a, b) -> torch.Tensor:
    """a (K, M)^T . b (K, N) in f32 (M, N), bf16 contiguous operands: a
    weight gradient summed over K token rows. N % 128 == 0, K % 8 == 0, M %
    8 == 0."""
    return _gemm_bwd("tn", a, b, "store", None)
