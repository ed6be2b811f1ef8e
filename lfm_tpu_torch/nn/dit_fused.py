"""DiT forward through the fused block kernels (port of lfm_tpu/nn/dit_fused.py).

A plain function over the model's parameters by state-dict name: the
embedders and the final layer are a handful of small bf16 Dense layers in
PyTorch (flax's rounding: the product rounded to bf16, then the bf16 bias
added); each of the ``depth`` blocks is one fused block, with the block's
adaLN ``mod`` Dense computed outside the kernel, as in the JAX package
(dit_fused.py:153). Sampling passes a bf16 copy of the parameters, cast once
outside the ODE loop (``cast_params_bf16``), and each block is K2
(``fused_dit_block``). Training (``train_vjp=True``) passes the model's live
f32 parameters; every use casts them to bf16, so autograd's cast backward
gives the f32 gradients, and each block is K5's differentiable
``make_fused_block_train``.

Mirrors DiT.forward in eval mode (nn/dit.py; reference models/DiT.py:231-272).
The gate is device-independent: on the CPU the same code runs and the
wrapper computes the kernel's plain version.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from lfm_tpu_torch.kernels.dit_block import fused_dit_block, layernorm_f32
from lfm_tpu_torch.kernels.dit_block_train import make_fused_block_train
from lfm_tpu_torch.nn.dit import DiT
from lfm_tpu_torch.nn.layers import dense, timestep_embedding

_BF = torch.bfloat16
# a block's weights and biases in the kernels' argument order
_BLOCK_PARAMS = ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
                 "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")


def _dense(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """bf16 Dense (dit_fused.py::_dense): x and the weight cast to bf16 (a
    no-op on the sampler's bf16 copy), the product rounded to bf16, then the
    bf16 bias added."""
    return dense(x, p[f"{name}.weight"], p.get(f"{name}.bias"), _BF)


def cast_params_bf16(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One bf16 copy of the DiT's float parameters for repeated evaluation."""
    return {k: (v.detach().to(torch.bfloat16).contiguous() if v.is_floating_point() else v)
            for k, v in state_dict.items()}


def embed_bf16(model, p: Dict[str, torch.Tensor], t: torch.Tensor, x: torch.Tensor,
               y: Optional[torch.Tensor]):
    """The embedders in bf16 (dit_fused.py:113-127, shared with
    dit_int8.py): tokens (N, T, D) with the position table added, and
    silu(t_emb + y_emb) (N, D). y None means the null label."""
    n, hh, ww, cc = x.shape
    ps = model.patch_size
    t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(n)
    if y is None:
        y = torch.full((n,), model.null_label, dtype=torch.int64, device=x.device)

    # patchify (nn/layers.py PatchEmbed): reshape + matmul, row-major patches
    xt = x.reshape(n, hh // ps, ps, ww // ps, ps, cc).permute(0, 1, 3, 2, 4, 5)
    xt = xt.reshape(n, (hh // ps) * (ww // ps), ps * ps * cc)
    w = p["x_embedder.proj.weight"]
    xt = dense(xt, w.permute(0, 2, 3, 1).reshape(model.hidden_size, -1),
               p["x_embedder.proj.bias"], _BF)
    xt = xt + model.pos_embed.to(_BF)

    # conditioning c = t_emb + y_emb
    te = timestep_embedding(t, 256).to(_BF)
    te = _dense(F.silu(_dense(te, p, "t_embedder.mlp.0")), p, "t_embedder.mlp.2")
    c = te + p["y_embedder.embedding_table.weight"][y].to(_BF)
    return xt.contiguous(), F.silu(c)


def fused_applicable(model, x: torch.Tensor) -> bool:
    """Gate of the fused sampling path: a bf16 DiT whose widths the kernel
    takes (d % 128 == 0, d % heads == 0, t % 8 == 0, t <= 1024)."""
    if not isinstance(model, DiT) or model.dtype != torch.bfloat16:
        return False
    d, heads = model.hidden_size, model.num_heads
    t = (model.img_resolution // model.patch_size) ** 2
    return d % 128 == 0 and d % heads == 0 and t % 8 == 0 and t <= 1024


def _pick_samples_per_cell(n: int) -> int:
    """The JAX package's grid cell: 4, 8, 2 or 1 samples, the first that
    divides the batch."""
    for s in (4, 8, 2, 1):
        if n % s == 0:
            return s
    return 1


def dit_fused_apply(model, params: Dict[str, torch.Tensor], t: torch.Tensor,
                    x: torch.Tensor, y: Optional[torch.Tensor] = None, *,
                    samples_per_cell: Optional[int] = None, train_vjp: bool = False,
                    bwd_samples_per_cell: int = 2) -> torch.Tensor:
    """Equivalent of ``model(t, x, y)`` in eval mode (no label dropout).

    Sampling: ``params`` is ``cast_params_bf16(model.state_dict())`` and
    every block is K2. With ``train_vjp=True``, ``params`` holds the model's
    live f32 parameters by state-dict name (``dict(model.named_parameters())``)
    and every block is ``make_fused_block_train(heads, samples_per_cell,
    bwd_samples_per_cell)``: K5's forward, and its hybrid backward through K3,
    so ``backward()`` through the result reaches every parameter.
    ``samples_per_cell`` defaults to the JAX package's pick."""
    p = params
    heads = model.num_heads
    s_cell = samples_per_cell or _pick_samples_per_cell(x.shape[0])
    xt, silu_c = embed_bf16(model, p, t, x, y)
    block_fn = make_fused_block_train(heads, s_cell, bwd_samples_per_cell) if train_vjp else None
    for i in range(model.depth):
        b = f"blocks.{i}."
        mod = _dense(silu_c, p, b + "adaLN_modulation.1").contiguous()  # (N, 6D)
        ws = [p[b + name].to(_BF) for name in _BLOCK_PARAMS]
        if train_vjp:
            xt = block_fn(xt, mod, *ws)
        else:
            xt = fused_dit_block(xt, mod, *ws, num_heads=heads)

    # final layer: f32 LayerNorm (fast variance), bf16 modulate
    shift, scale = _dense(silu_c, p, "final_layer.adaLN_modulation.1").chunk(2, dim=-1)
    xt = layernorm_f32(xt.float()).to(_BF) * (1.0 + scale[:, None, :]) \
        + shift[:, None, :]
    xt = _dense(xt, p, "final_layer.linear")
    return model.unpatchify(xt).float()


def dit_fused_model_apply(model: torch.nn.Module) -> Callable[..., torch.Tensor]:
    """``model_apply`` for ``make_train_step``: the DiT's velocity through its
    fused blocks, ``dit_fused_apply(..., train_vjp=True)`` over the model's
    live parameters. The fused path has no label dropout (neither has
    JAX's): a step that asks for it raises."""
    params = dict(model.named_parameters())

    def apply(t, z_t, y, generator=None):
        if generator is not None:
            raise NotImplementedError("the fused DiT path has no label dropout")
        return dit_fused_apply(model, params, t, z_t, y, train_vjp=True)

    return apply
