"""DiT forward through the fused block kernel (port of lfm_tpu/nn/dit_fused.py).

A plain function over a bf16 copy of the model's parameters: the embedders
and the final layer are a handful of small matmuls in PyTorch; each of the
``depth`` blocks is one ``fused_dit_block`` call (K2), with the block's
adaLN ``mod`` Dense computed outside the kernel, as in the JAX package
(dit_fused.py:153). The parameters are cast to bf16 once
(``cast_params_bf16``), outside the ODE loop.

Mirrors DiT.forward in eval mode (nn/dit.py; reference models/DiT.py:231-272).
The gate is device-independent: on the CPU the same code runs and the
wrapper computes the kernel's plain version.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from lfm_tpu_torch.kernels.dit_block import fused_dit_block, layernorm_f32
from lfm_tpu_torch.nn.dit import DiT
from lfm_tpu_torch.nn.layers import timestep_embedding


def _dense(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """bf16 Dense (dit_fused.py::_dense): bf16 matmul, bf16 bias."""
    return F.linear(x.to(torch.bfloat16), p[f"{name}.weight"], p.get(f"{name}.bias"))


def cast_params_bf16(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One bf16 copy of the DiT's float parameters for repeated evaluation."""
    return {k: (v.detach().to(torch.bfloat16).contiguous() if v.is_floating_point() else v)
            for k, v in state_dict.items()}


def fused_applicable(model, x: torch.Tensor) -> bool:
    """Gate of the fused sampling path: a bf16 DiT whose widths the kernel
    takes (d % 128 == 0, d % heads == 0, t % 8 == 0, t <= 1024)."""
    if not isinstance(model, DiT) or model.dtype != torch.bfloat16:
        return False
    d, heads = model.hidden_size, model.num_heads
    t = (model.img_resolution // model.patch_size) ** 2
    return d % 128 == 0 and d % heads == 0 and t % 8 == 0 and t <= 1024


def dit_fused_apply(model, params: Dict[str, torch.Tensor], t: torch.Tensor,
                    x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Equivalent of ``model(t, x, y)`` with every block through K2.
    ``params`` is ``cast_params_bf16(model.state_dict())``."""
    p = params
    n, hh, ww, cc = x.shape
    ps = model.patch_size
    d = model.hidden_size
    heads = model.num_heads

    t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(n)
    if y is None:
        y = torch.full((n,), model.null_label, dtype=torch.int64, device=x.device)

    # patchify (nn/layers.py PatchEmbed): reshape + matmul, row-major patches
    xt = x.reshape(n, hh // ps, ps, ww // ps, ps, cc).permute(0, 1, 3, 2, 4, 5)
    xt = xt.reshape(n, (hh // ps) * (ww // ps), ps * ps * cc)
    w = p["x_embedder.proj.weight"]
    xt = F.linear(xt.to(torch.bfloat16), w.permute(0, 2, 3, 1).reshape(d, -1),
                  p["x_embedder.proj.bias"])
    xt = xt + model.pos_embed.to(torch.bfloat16)

    # conditioning c = t_emb + y_emb
    te = timestep_embedding(t, 256).to(torch.bfloat16)
    te = _dense(F.silu(_dense(te, p, "t_embedder.mlp.0")), p, "t_embedder.mlp.2")
    c = te + p["y_embedder.embedding_table.weight"][y]
    silu_c = F.silu(c)

    xt = xt.contiguous()
    for i in range(model.depth):
        b = f"blocks.{i}."
        mod = _dense(silu_c, p, b + "adaLN_modulation.1").contiguous()  # (N, 6D)
        xt = fused_dit_block(
            xt, mod,
            p[b + "attn.qkv.weight"], p[b + "attn.qkv.bias"],
            p[b + "attn.proj.weight"], p[b + "attn.proj.bias"],
            p[b + "mlp.fc1.weight"], p[b + "mlp.fc1.bias"],
            p[b + "mlp.fc2.weight"], p[b + "mlp.fc2.bias"],
            num_heads=heads)

    # final layer: f32 LayerNorm (fast variance), bf16 modulate
    shift, scale = _dense(silu_c, p, "final_layer.adaLN_modulation.1").chunk(2, dim=-1)
    xt = layernorm_f32(xt.float()).to(torch.bfloat16) * (1.0 + scale[:, None, :]) \
        + shift[:, None, :]
    xt = _dense(xt, p, "final_layer.linear")
    return model.unpatchify(xt).float()
