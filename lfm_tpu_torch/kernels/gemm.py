"""The NT GEMM of K2, K5's forward and P1-bf16, and its plain version.

``out (M, N) = epilogue(a (M, K) . w (N, K)^T)``, the products of
lfm_tpu/kernels/dit_block.py::_dit_block_kernel (and of K5's `_fwd_kernel`)
with their epilogues at the same rounding points: the product of bf16
operands summed in f32, then in f32

- ``bias``       out = value + bias
- ``store``      out = value
- ``gelu``       out = gelu_tanh(value + bias)
- ``gelu_aux``   the same, and aux = bf16(value + bias)
- ``gated``      out = f32(resid) + f32(mod[m // tokens, gate * N + n]) * (value + bias)
- ``gated_aux``  the same, aux = bf16(value + bias) and aux2 = bf16(out)

with a null bias adding nothing and out rounded once to ``out_dtype``. The
blocks call the kernel from C (``csrc/dit_block.cu``,
``csrc/dit_block_train.cu``, ``csrc/int8_gemm.cu``); this wrapper gives the
kernel, ``csrc/gemm_sm90.cuh``, a call of its own for the tests,
``chip_smoke.py`` and ``tools/bench_block.py``. On a CPU tensor ``gemm``
computes the plain version; on a CUDA tensor it launches the kernel or
raises. Its checks do not depend on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lfm_tpu_torch.kernels._build import LaunchCounter, check_rc, load_library

GEMM = LaunchCounter()
# the C epilogue codes (csrc/gemm.cuh): EPILOGUES[code]
EPILOGUES = ("bias", "gelu", "gated", "gelu_aux", "gated_aux", "store")
TILE_N, TILE_K = 128, 64
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

