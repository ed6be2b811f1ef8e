"""w8a8 int8 DiT sampling path (port of lfm_tpu/nn/dit_int8.py).

The four matmuls of every block (qkv, proj, fc1, fc2) run int8: the weights
are quantized once, symmetric per output channel, and the activations per
row at every call:

    y = (int8(x) @ int8(W)^T) [int32 sums] * s_x[:, None] * s_w[None, :]

Everything else keeps the bf16/f32 numerics of the JAX module: the bf16
embedders, adaLN modulation and final Dense (nn/dit_fused.py), the f32
residual stream and LayerNorm, and plain bf16 softmax attention with f32
logits. On the card each quantized product is one ``int8_dense`` call (the
hand-written int8 GEMM of kernels/int8_matmul.py, P1's port); on the CPU
the same calls compute its plain version.

The parameters are a flat dict by the model's state-dict names
(``quantize_params_int8``): each quantized ``blocks.{i}.<layer>.weight``
becomes ``<layer>.q`` (int8, (out, in), the Linear layout, ``in``
contiguous) and ``<layer>.s`` (f32 (out,)); every other float tensor is
cast to bf16 once. JAX's ``q`` is (in, out): the port's is its transpose.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from lfm_tpu_torch.kernels.dit_block import layernorm_f32
from lfm_tpu_torch.kernels.int8_matmul import int8_dense, reference_int8_dense
from lfm_tpu_torch.nn.dit import DiT
from lfm_tpu_torch.nn.dit_fused import _dense, cast_params_bf16, embed_bf16

_BF = torch.bfloat16
# the block layers whose weights are quantized; adaLN stays bf16
QUANT_LAYERS = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")


def quantize_weight(w: torch.Tensor):
    """Symmetric per-output-channel int8 of a Linear weight (out, in):
    ``w ~= q * s[:, None]``; q int8 (out, in), s f32 (out,)
    (dit_int8.py::quantize_weight, whose (in, out) kernel reduces over in).
    The divisor 127 is a tensor, so no backend multiplies by its
    reciprocal instead."""
    wf = w.detach().float()
    m = wf.abs().amax(dim=-1)
    s = torch.clamp(m, min=1e-8) / torch.full_like(m, 127.0)
    q = torch.clamp(torch.round(wf / s[:, None]), -127, 127).to(torch.int8)
    return q.contiguous(), s


def quantize_params_int8(model, state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One-time conversion of a DiT's f32 state dict for ``dit_int8_apply``:
    the blocks' qkv/proj/fc1/fc2 weights -> ``.q`` and ``.s``, quantized from
    the f32 values; everything else cast to bf16 (``cast_params_bf16``)."""
    keys = [f"blocks.{i}.{layer}" for i in range(model.depth) for layer in QUANT_LAYERS]
    weights = {f"{key}.weight" for key in keys}
    out = cast_params_bf16({k: v for k, v in state_dict.items() if k not in weights})
    for key in keys:
        out[f"{key}.q"], out[f"{key}.s"] = quantize_weight(state_dict[f"{key}.weight"])
    return out


def int8_model_ok(model) -> bool:
    """Model-only eligibility: a DiT whose width divides into its heads. The
    port's blocks are always a list (JAX asks for ``scan_blocks``, the
    layout its quantized tree is stacked in). No input-shape constraint, so
    ``make_sampler`` can quantize once, before any input is seen."""
    return isinstance(model, DiT) and model.hidden_size % model.num_heads == 0


def int8_applicable(model, x: torch.Tensor) -> bool:
    """The gate at a call site that holds an input: the model-only check,
    on any device (the CPU runs the plain versions)."""
    del x
    return int8_model_ok(model)


def _quant_dense(x: torch.Tensor, p: Dict[str, torch.Tensor], key: str,
                 epilogue: str = "store", out_dtype: torch.dtype = torch.float32,
                 plain: bool = False) -> torch.Tensor:
    """dit_int8.py::_dense_int8 (rows, K) -> (rows, N) through ``int8_dense``
    (its plain version with ``plain``)."""
    dense = reference_int8_dense if plain else int8_dense
    return dense(x, p[f"{key}.q"], p[f"{key}.s"], p.get(f"{key}.bias"), epilogue, out_dtype)


def attention_bf16(qkv: torch.Tensor, n: int, t: int, heads: int, head_dim: int) -> torch.Tensor:
    """dit_int8.py::_attention_bf16, (N*T, 3C) bf16 -> (N*T, C) bf16: f32
    logits of the bf16 q and k, divided by sqrt(head_dim) after the
    product, softmax in f32, p rounded to bf16, PV summed in f32. Plain
    tensor code, as JAX leaves it to XLA."""
    c = heads * head_dim
    qkv = qkv.reshape(n, t, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    q, k, v = (a.reshape(n * heads, t, head_dim) for a in qkv)
    # a divisor on the logits' device: a CPU scalar would become a product
    # with its reciprocal on the card
    root = torch.sqrt(torch.tensor(float(head_dim), device=qkv.device))
    logits = _bmm_f32(q, k.transpose(1, 2)) / root
    p = torch.softmax(logits, dim=-1)
    o = _bmm_f32(p.to(_BF), v)  # (N*H, T, hd)
    return o.to(_BF).reshape(n, heads, t, head_dim).transpose(1, 2).reshape(n * t, c)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 batches, summed and returned in f32 (a dot_general with
    preferred_element_type=f32): cuBLAS on the card, f32 on the CPU."""
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def dit_int8_apply(model, qparams: Dict[str, torch.Tensor], t: torch.Tensor, x: torch.Tensor,
                   y: Optional[torch.Tensor] = None, *, plain: bool = False) -> torch.Tensor:
    """``model(t, x, y)`` in eval mode with the block matmuls in int8.
    ``qparams`` comes from ``quantize_params_int8``. Mirrors
    dit_int8.py::dit_int8_apply: f32 residual stream, f32 output. ``plain``
    computes every quantized product with its plain version on any device:
    the yardstick the kernels are held to on the card."""
    p = qparams
    n = x.shape[0]
    d = model.hidden_size
    heads = model.num_heads
    hd = d // heads

    xt, silu_c = embed_bf16(model, p, t, x, y)
    tok = xt.shape[1]
    rows = n * tok
    xf = xt.float()  # (N, T, C) f32 residual stream
    for i in range(model.depth):
        b = f"blocks.{i}."
        mod = _dense(silu_c, p, b + "adaLN_modulation.1").float().reshape(n, 6, 1, d)
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = (mod[:, j] for j in range(6))

        h = layernorm_f32(xf) * (1.0 + sc_msa) + sh_msa
        qkv = _quant_dense(h.reshape(rows, d), p, b + "attn.qkv", out_dtype=_BF, plain=plain)
        attn = attention_bf16(qkv, n, tok, heads, hd)
        proj = _quant_dense(attn, p, b + "attn.proj", plain=plain)
        xf = xf + g_msa * proj.reshape(n, tok, d)

        h = layernorm_f32(xf) * (1.0 + sc_mlp) + sh_mlp
        h1 = _quant_dense(h.reshape(rows, d), p, b + "mlp.fc1", "gelu", plain=plain)
        h2 = _quant_dense(h1, p, b + "mlp.fc2", plain=plain)
        xf = xf + g_mlp * h2.reshape(n, tok, d)

    shift, scale = _dense(silu_c, p, "final_layer.adaLN_modulation.1").float().chunk(2, dim=-1)
    xt = (layernorm_f32(xf) * (1.0 + scale[:, None, :]) + shift[:, None, :]).to(_BF)
    xt = _dense(xt, p, "final_layer.linear")
    return model.unpatchify(xt).float()
