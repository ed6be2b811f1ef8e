"""w8a8 int8 products: the CUDA kernels of P1 and their plain versions.

Port of tools/microbench_int8_pallas.py's two Pallas kernels (P1), which
model the MLP half of the w8a8 DiT path (lfm_tpu/nn/dit_int8.py:220-226):

* ``_kernel_int8`` (``run_int8``): per-row int8 quantization, an int8
  product with int32 sums, the f32 dequant, tanh-GELU, per-row quantization
  again, a second int8 product and its dequant. Here it is two kernels of
  ``csrc/int8_gemm.cu``, chained by the wrappers: ``quant_rows`` and the
  int8 GEMM with its dequant epilogue, which ``int8_dense`` launches for
  every quantized product of ``nn/dit_int8.py`` and ``int8_mlp`` chains
  into one step of the probe.
* ``_kernel_bf16`` (``run_bf16``): the same step in bf16, the probe's
  yardstick: ``bf16_mlp``, two of K2's bf16 GEMMs.

Quantization is the path's (dit_int8.py:121-127): ``s = max(max|x|, 1e-8)
/ 127`` and ``q = clip(round(x / s), -127, 127)``, both true divisions and
ties to even. The probe's own ``_quant_rows`` multiplies by ``1 / 127``
instead, which can differ from the division in the last bit of ``s``;
tests/test_torch_int8.py states what that does to the chain.

Int8 weights are (out, in) with ``in`` contiguous, the ``torch.nn.Linear``
layout (JAX's ``q`` is (in, out)); their scales are (out,) f32. The plain
int8 product sums in float64, where every partial sum of int8 products is
an exact integer, so it is the int32 sum; its conversion to f32 rounds as
int32 -> f32 does. The kernel's epilogue evaluates GELU in the order of
PyTorch's CUDA ``F.gelu``, so on the card every product equals its plain
version bit for bit. On a CPU tensor each wrapper computes its plain
version; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lfm_tpu_torch.kernels._build import LaunchCounter, check_rc, load_library

QUANT_ROWS = LaunchCounter()
INT8_DENSE = LaunchCounter()
INT8_MLP = LaunchCounter()
BF16_MLP = LaunchCounter()
EPILOGUES = ("store", "gelu")
FLOAT_DTYPES = (torch.float32, torch.bfloat16)  # x's types and out's
# the int8 GEMM's tile widths (int8_gemm.cu): N % 128 == 0, K % 64 == 0;
# the bf16 GEMMs take N % 128 == 0 and K % 32 == 0 (gemm.cuh)
TILE_N, TILE_K = 128, 64
_BF = torch.bfloat16


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def reference_quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row quantization (dit_int8.py::_quant_rows):
    (q int8 like x, s f32 (rows, 1)). The divisor 127 is a tensor, so that
    no backend turns the division into a product with its reciprocal."""
    xf = x.float()
    m = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(m, min=1e-8) / torch.full_like(m, 127.0)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def _int8_product(qa: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """qa (rows, K) int8 times q_w (N, K) int8 transposed: the exact integer
    sums (float64 holds every partial sum), rounded to f32."""
    return (qa.double() @ q_w.double().T).float()


def _dequant(acc, sx, s_w, bias, epilogue: str) -> torch.Tensor:
    """The f32 epilogue in JAX's order: acc * s_x * s_w, + bias, GELU."""
    y = acc * sx * s_w.reshape(1, -1)
    if bias is not None:
        y = y + bias.float()
    if epilogue == "gelu":
        y = F.gelu(y, approximate="tanh")
    return y


def reference_int8_dense(x, q_w, s_w, bias=None, epilogue: str = "store",
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of ``int8_dense`` (dit_int8.py::_dense_int8, with fc1's
    GELU as an epilogue)."""
    qx, sx = reference_quant_rows(x)
    return _dequant(_int8_product(qx, q_w), sx, s_w, bias, epilogue).to(out_dtype)


def reference_int8_mlp(x, q1, s1, b1, q2, s2, b2) -> torch.Tensor:
    """Plain version of one ``int8_mlp`` step, f32 out."""
    h = reference_int8_dense(x, q1, s1, b1, "gelu")
    return reference_int8_dense(h, q2, s2, b2, "store")


def reference_bf16_mlp(x, w1, w2) -> torch.Tensor:
    """Plain version of one ``bf16_mlp`` step (one pass of ``_kernel_bf16``'s
    loop): bf16 products summed in f32, the f32 GELU rounded to bf16, the
    second product rounded to bf16 (as the next step reads it)."""
    h = F.gelu(x.to(_BF).float() @ w1.float().T, approximate="tanh").to(_BF)
    return (h.float() @ w2.float().T).to(_BF)


# --------------------------------------------------------------------------
# checks shared by the wrappers
# --------------------------------------------------------------------------

def _fail(fn: str, msg: str) -> None:
    raise ValueError(f"{fn}: {msg}")


def _check_device(fn: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        _fail(fn, f"unsupported device {x.device}")


def _check_on(fn: str, name: str, a: torch.Tensor, dtype, device) -> None:
    if a.dtype != dtype or a.device != device or not a.is_contiguous():
        _fail(fn, f"{name} must be a contiguous {dtype} tensor on {device}, got "
                  f"{a.dtype} on {a.device} (contiguous: {a.is_contiguous()})")


def _check_dense_args(fn: str, x, q_w, s_w, bias) -> Tuple[int, int, int]:
    """(rows, K, N) of a quantized product; raises on what no version takes."""
    if x.dim() != 2 or q_w.dim() != 2:
        _fail(fn, f"x and q_w must be 2-D, got {tuple(x.shape)} and {tuple(q_w.shape)}")
    rows, k = x.shape
    n = q_w.shape[0]
    if q_w.dtype != torch.int8 or q_w.shape[1] != k:
        _fail(fn, f"q_w must be int8 (N, {k}), got {q_w.dtype} {tuple(q_w.shape)}")
    if tuple(s_w.shape) != (n,) or s_w.dtype != torch.float32:
        _fail(fn, f"s_w must be f32 ({n},), got {s_w.dtype} {tuple(s_w.shape)}")
    if bias is not None and tuple(bias.shape) != (n,):
        _fail(fn, f"bias must be ({n},), got {tuple(bias.shape)}")
    return rows, k, n


def _check_tiles(fn: str, n: int, k: int, tile_k: int = TILE_K) -> None:
    if n % TILE_N or k % tile_k:
        _fail(fn, f"the kernel needs N % {TILE_N} == 0 and K % {tile_k} == 0, "
                  f"got N={n} K={k}")


# --------------------------------------------------------------------------
# launches (no checks, no counts) and the wrappers
# --------------------------------------------------------------------------

def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    rows, k = x.shape
    q = torch.empty((rows, k), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    rc = load_library().lfm_quant_rows(x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, k,
                                       int(x.dtype == torch.float32), _stream(x.device))
    check_rc("quant_rows", rc)
    return q, s


def _launch_gemm(qx, sx, q_w, s_w, bias, gelu: bool, out_dtype) -> torch.Tensor:
    rows, k = qx.shape
    n = q_w.shape[0]
    out = torch.empty((rows, n), dtype=out_dtype, device=qx.device)
    rc = load_library().lfm_int8_gemm(
        qx.data_ptr(), q_w.data_ptr(), sx.data_ptr(), s_w.data_ptr(),
        0 if bias is None else bias.data_ptr(), out.data_ptr(), rows, n, k, int(gelu),
        int(out_dtype == torch.float32), _stream(qx.device))
    check_rc("int8_gemm", rc)
    return out


def quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 (rows, K), s f32 (rows, 1)) of x (rows, K). On CUDA: x
    contiguous, bf16 or f32."""
    if x.dim() != 2:
        _fail("quant_rows", f"x must be 2-D (rows, K), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return reference_quant_rows(x)
    _check_device("quant_rows", x)
    if x.dtype not in FLOAT_DTYPES or not x.is_contiguous():
        _fail("quant_rows", f"x must be contiguous bf16 or f32, got {x.dtype} "
                            f"(contiguous: {x.is_contiguous()})")
    q, s = _launch_quant(x)
    QUANT_ROWS.count += 1
    return q, s


def _check_cuda_dense(fn: str, x, q_w, s_w, bias, n: int, k: int) -> None:
    _check_device(fn, x)
    _check_tiles(fn, n, k)
    dev = x.device
    _check_on(fn, "q_w", q_w, torch.int8, dev)
    _check_on(fn, "s_w", s_w, torch.float32, dev)
    if bias is not None:
        _check_on(fn, "bias", bias, _BF, dev)


def int8_dense(x: torch.Tensor, q_w: torch.Tensor, s_w: torch.Tensor,
               bias: Optional[torch.Tensor] = None, epilogue: str = "store",
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (rows, K) quantized per row, times q_w (N, K) int8 with scales s_w
    (N,) f32, dequantized in f32, plus bias (N,), then GELU for
    ``epilogue="gelu"``; out (rows, N) in ``out_dtype`` (f32 or bf16).

    On CUDA: x contiguous bf16 or f32 (``quant_rows``), N % 128 == 0,
    K % 64 == 0, q_w and s_w contiguous, bias bf16."""
    fn = "int8_dense"
    rows, k, n = _check_dense_args(fn, x, q_w, s_w, bias)
    if epilogue not in EPILOGUES:
        _fail(fn, f"epilogue {epilogue!r} is not one of {EPILOGUES}")
    if out_dtype not in FLOAT_DTYPES:
        _fail(fn, f"out_dtype {out_dtype} is not one of {FLOAT_DTYPES}")
    if x.device.type == "cpu":
        return reference_int8_dense(x, q_w, s_w, bias, epilogue, out_dtype)
    _check_cuda_dense(fn, x, q_w, s_w, bias, n, k)
    qx, sx = quant_rows(x)
    out = _launch_gemm(qx, sx, q_w, s_w, bias, epilogue == "gelu", out_dtype)
    INT8_DENSE.count += 1
    return out


def int8_mlp(x: torch.Tensor, q1: torch.Tensor, s1: torch.Tensor, b1: Optional[torch.Tensor],
             q2: torch.Tensor, s2: torch.Tensor, b2: Optional[torch.Tensor]) -> torch.Tensor:
    """One step of ``_kernel_int8``'s chain, with optional biases: x (rows,
    D) -> quantize -> q1 (H, D) -> dequant, + b1, GELU (f32) -> quantize ->
    q2 (D, H) -> dequant, + b2; out (rows, D) f32. On CUDA: the shapes and
    types of two ``int8_dense`` calls (D and H % 128 == 0)."""
    fn = "int8_mlp"
    rows, d, h = _check_dense_args(fn, x, q1, s1, b1)
    if (q2.dtype != torch.int8 or tuple(q2.shape) != (d, h) or s2.dtype != torch.float32
            or tuple(s2.shape) != (d,) or (b2 is not None and tuple(b2.shape) != (d,))):
        _fail(fn, f"q2, s2 and b2 must be int8 ({d}, {h}), f32 ({d},) and ({d},), got "
                  f"{q2.dtype} {tuple(q2.shape)}, {s2.dtype} {tuple(s2.shape)} and "
                  f"{None if b2 is None else tuple(b2.shape)}")
    if x.device.type == "cpu":
        return reference_int8_mlp(x, q1, s1, b1, q2, s2, b2)
    _check_cuda_dense(fn, x, q1, s1, b1, h, d)
    _check_cuda_dense(fn, x, q2, s2, b2, d, h)
    if x.dtype not in FLOAT_DTYPES or not x.is_contiguous():
        _fail(fn, f"x must be contiguous bf16 or f32, got {x.dtype}")
    qx, sx = _launch_quant(x)
    hid = _launch_gemm(qx, sx, q1, s1, b1, True, torch.float32)
    qh, sh = _launch_quant(hid)
    out = _launch_gemm(qh, sh, q2, s2, b2, False, torch.float32)
    INT8_MLP.count += 1
    return out


def bf16_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """One step of ``_kernel_bf16``'s chain: x (rows, D) bf16, w1 (H, D) and
    w2 (D, H) bf16 in Linear layout; out (rows, D) bf16. On CUDA: all
    contiguous, D and H % 128 == 0."""
    fn = "bf16_mlp"
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        _fail(fn, "x, w1 and w2 must be 2-D")
    rows, d = x.shape
    h = w1.shape[0]
    if tuple(w1.shape) != (h, d) or tuple(w2.shape) != (d, h):
        _fail(fn, f"w1 must be (H, {d}) and w2 ({d}, H), got {tuple(w1.shape)} and "
                  f"{tuple(w2.shape)}")
    if x.device.type == "cpu":
        return reference_bf16_mlp(x, w1, w2)
    _check_device(fn, x)
    _check_tiles(fn, d, h, 32)
    _check_tiles(fn, h, d, 32)
    for name, a in (("x", x), ("w1", w1), ("w2", w2)):
        _check_on(fn, name, a, _BF, x.device)
    hid = torch.empty((rows, h), dtype=_BF, device=x.device)
    out = torch.empty((rows, d), dtype=_BF, device=x.device)
    rc = load_library().lfm_bf16_mlp(x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                                     hid.data_ptr(), out.data_ptr(), rows, d, h,
                                     _stream(x.device))
    check_rc(fn, rc)
    BF16_MLP.count += 1
    return out
