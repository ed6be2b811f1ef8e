"""DiT velocity network, adaLN-Zero (port of lfm_tpu/nn/dit.py).

Reference models/DiT.py:112-415. Latents are NHWC at the public interface,
as in the JAX package. The blocks are a plain ``nn.ModuleList`` (the JAX
package's ``nn.scan`` exists for XLA's compile time); the JAX converter's
scan-stacked block params map onto ``blocks.{i}`` (nn/convert_dit.py).
``forward`` is ``DiT.__call__``: ``train=True`` turns on label dropout, and
with ``remat`` every block is recomputed in backward under
``remat_policy`` (``torch.utils.checkpoint``, non-reentrant; the JAX
package's ``nn.remat`` over each block, reference models/DiT.py:265-269):

* None: the whole block is recomputed;
* ``"dots"``: the outputs of the products with no batch dimension (every
  Linear, ``aten.mm`` / ``aten.addmm``) are saved and the rest recomputed,
  the attention included: K1 runs again in backward, as JAX's
  ``pallas_call`` does under its policy;
* ``"all_dots"``: also the batched products (``aten.bmm`` /
  ``aten.baddbmm``, the plain attention's); K1 is a kernel, not such a
  product, and still runs again;
* ``"dots_attn"``: ``"dots"`` and the attention's output (JAX's
  ``attn_out``): the block is checkpointed as two regions under the dots
  policy, up to the qkv product and from the output projection on, and
  the attention between them runs once, outside both, so autograd keeps
  its output and K1 is not run again.

A policy sees only the ATen operators that run on its tensors; a kernel
launched through ctypes into a ``torch.empty`` is invisible to it, which
is why ``dots_attn`` takes the attention out of the regions rather than
naming its output.

Under sequence parallelism (inside ``layers.row_sharded``, which
sample/sp.py enters) x is this rank's contiguous rows of the latent: the position table is sliced to
them, every token-local layer runs on them, and the attention is the ring
over the seq group (nn/layers.py). The parameters are those of the whole
model.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from lfm_tpu_torch.core.device import DeviceLike, resolve_device
from lfm_tpu_torch.nn.layers import (
    Attention,
    LabelEmbedder,
    Mlp,
    PatchEmbed,
    TimestepEmbedder,
    get_2d_sincos_pos_embed,
    layer_norm,
    row_shard,
    linear,
    modulate,
)

# depth, hidden_size, patch_size, num_heads (models/DiT.py:354-415)
DIT_CONFIGS = {
    "DiT-XL/2": (28, 1152, 2, 16),
    "DiT-XL/4": (28, 1152, 4, 16),
    "DiT-XL/8": (28, 1152, 8, 16),
    "DiT-L/2": (24, 1024, 2, 16),
    "DiT-L/4": (24, 1024, 4, 16),
    "DiT-L/8": (24, 1024, 8, 16),
    "DiT-B/2": (12, 768, 2, 12),
    "DiT-B/4": (12, 768, 4, 12),
    "DiT-B/8": (12, 768, 8, 12),
    "DiT-S/2": (12, 384, 2, 6),
    "DiT-S/4": (12, 384, 4, 6),
    "DiT-S/8": (12, 384, 8, 6),
    # the JAX package's test-scale configs (lfm_tpu/nn/dit.py:77,80)
    "DiT-T/2": (2, 64, 2, 4),
    "DiT-T4/2": (4, 64, 2, 4),
}
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCH_DOTS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
# remat_policy -> the operators whose outputs a checkpointed block saves
# (lfm_tpu/nn/dit.py::REMAT_POLICIES); None recomputes the whole block
REMAT_POLICIES = {None: None, "dots": _DOTS, "all_dots": _DOTS + _BATCH_DOTS,
                  "dots_attn": _DOTS}


class DiTBlock(nn.Module):
    """adaLN-Zero block (models/DiT.py:112-131): shift/scale/gate for the
    attention and MLP halves, in that order."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 use_flash: bool = False):
        super().__init__()
        self.attn = Attention(hidden_size, num_heads, use_flash=use_flash)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden_size, 6 * hidden_size))

    def forward(self, x: torch.Tensor, c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h, mod = self.pre_attention(x, c, dtype)
        return self.post_attention(x, self.attn.attend(h, dtype), mod, dtype)

    def pre_attention(self, x, c, dtype):
        """adaLN's six vectors and the attention half's modulated LayerNorm."""
        mod = linear(F.silu(c), self.adaLN_modulation[1], dtype)
        s_msa, sc_msa = mod.chunk(6, dim=-1)[:2]
        return modulate(layer_norm(x).to(dtype), s_msa, sc_msa), mod

    def post_attention(self, x, attn_out, mod, dtype):
        """From the attention's output projection to the block's output."""
        _, _, g_msa, s_mlp, sc_mlp, g_mlp = mod.chunk(6, dim=-1)
        x = x + g_msa[:, None, :] * linear(attn_out, self.attn.proj, dtype)
        h = modulate(layer_norm(x).to(dtype), s_mlp, sc_mlp)
        return x + g_mlp[:, None, :] * self.mlp(h, dtype)

    def forward_remat(self, x: torch.Tensor, c: torch.Tensor, dtype: torch.dtype,
                      policy: Optional[str]) -> torch.Tensor:
        """``forward``, recomputed in backward under ``policy``
        (REMAT_POLICIES; the module docstring)."""
        if policy is None:
            return checkpoint(self, x, c, dtype, use_reentrant=False)
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                list(REMAT_POLICIES[policy]))
        if policy != "dots_attn":
            return checkpoint(self, x, c, dtype, use_reentrant=False, context_fn=ctx)
        h, mod = checkpoint(self.pre_attention, x, c, dtype, use_reentrant=False,
                            context_fn=ctx)
        attn_out = self.attn.attend(h, dtype)
        return checkpoint(self.post_attention, x, attn_out, mod, dtype, use_reentrant=False,
                          context_fn=ctx)


class FinalLayer(nn.Module):
    """2-way modulation + linear head (models/DiT.py:134-149)."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(hidden_size, patch_size * patch_size * out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden_size, 2 * hidden_size))

    def forward(self, x: torch.Tensor, c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        shift, scale = linear(F.silu(c), self.adaLN_modulation[1], dtype).chunk(2, dim=-1)
        x = modulate(layer_norm(x).to(dtype), shift, scale)
        return linear(x, self.linear, dtype)


class DiT(nn.Module):
    """Velocity network v(t, x, y); x is (N, H, W, C) latents.

    Parameters are float32 masters; ``dtype`` is the compute type (bf16 on
    the card's sampling path), as the flax module's ``dtype`` field."""

    def __init__(self, img_resolution: int = 32, patch_size: int = 2,
                 in_channels: int = 4, hidden_size: int = 1152, depth: int = 28,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 label_dropout: float = 0.0, num_classes: int = 1,
                 learn_sigma: bool = False, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, remat: bool = False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}; one of "
                             f"{list(REMAT_POLICIES)}")
        self.img_resolution = img_resolution
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.hidden_size = hidden_size
        self.depth = depth
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.label_dropout = label_dropout
        self.num_classes = num_classes
        self.learn_sigma = learn_sigma
        self.dtype = dtype
        self.use_flash = use_flash
        self.remat = remat
        self.remat_policy = remat_policy

        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.y_embedder = LabelEmbedder(num_classes, hidden_size, label_dropout)
        g = img_resolution // patch_size
        # a fixed buffer, recomputed rather than stored (the reference
        # checkpoint's pos_embed holds the same table)
        self.register_buffer(
            "pos_embed", torch.from_numpy(get_2d_sincos_pos_embed(hidden_size, g))[None],
            persistent=False)
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_size, num_heads, mlp_ratio, use_flash=use_flash)
            for _ in range(depth))
        self.final_layer = FinalLayer(hidden_size, patch_size, self.out_channels)

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.learn_sigma else self.in_channels

    @property
    def null_label(self) -> int:
        # y=None falls back to the last table row (models/DiT.py:259-260)
        return self.num_classes + int(self.label_dropout > 0) - 1

    def embed(self, t: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor],
              train: bool = False, generator: Optional[torch.Generator] = None,
              force_drop_ids: Optional[torch.Tensor] = None):
        """Tokens (N, T, D) and conditioning c (N, D), both in ``dtype``."""
        n, hh, ww, cc = x.shape
        pos = self.pos_embed
        shard = row_shard()
        if shard is None:
            if hh != self.img_resolution or cc != self.in_channels:
                raise ValueError(f"expected NHWC ({self.img_resolution}, {self.in_channels}), "
                                 f"got {tuple(x.shape)}")
        else:
            _, index, sp = shard
            if hh * sp != self.img_resolution or ww != self.img_resolution:
                raise ValueError(f"sp={sp}: expected a row shard of H={self.img_resolution}"
                                 f"//{sp}, got {tuple(x.shape)}")
            if hh % self.patch_size:
                raise ValueError(f"row-shard height {hh} must align to patch_size "
                                 f"{self.patch_size}")
            # this rank's contiguous rows of the patch grid
            g = self.img_resolution // self.patch_size
            g_loc = hh // self.patch_size
            pos = pos[:, index * g_loc * g:(index + 1) * g_loc * g]
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(n)
        if y is None:
            y = torch.full((n,), self.null_label, dtype=torch.int64, device=x.device)
        dt = self.dtype
        tok = self.x_embedder(x.to(dt), dt) + pos.to(dt)
        c = self.t_embedder(t, dt) + self.y_embedder(y, dt, train, generator, force_drop_ids)
        return tok, c

    def forward(self, t: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None,
                force_drop_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """v(t, x, y). ``train`` turns on label dropout, drawn from
        ``generator``; ``force_drop_ids`` pins its mask."""
        tok, c = self.embed(t, x, y, train, generator, force_drop_ids)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                tok = block.forward_remat(tok, c, self.dtype, self.remat_policy)
            else:
                tok = block(tok, c, self.dtype)
        tok = self.final_layer(tok, c, self.dtype)
        return self.unpatchify(tok).float()

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """(N, T, p*p*C) -> (N, H, W, C); inverse of PatchEmbed's layout.
        Under sequence parallelism T is a row shard of the patch grid and
        the output the matching rows of the image."""
        n, tt, _ = x.shape
        p = self.patch_size
        g = self.img_resolution // p
        g_rows = tt // g
        c = self.out_channels
        x = x.reshape(n, g_rows, g, p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, g_rows * p, g * p, c)

    def forward_with_cfg(self, t, x, y, cfg_scale: float,
                         guide_channels: Optional[int] = None) -> torch.Tensor:
        """Reference-parity CFG on a pre-doubled batch (models/DiT.py:274-290):
        x has 2N rows, y = [y_cond, y_null]."""
        n = x.shape[0] // 2
        half = x[:n]
        out = self(t, torch.cat([half, half], dim=0), y)
        gc = self.in_channels if guide_channels is None else guide_channels
        eps, rest = out[..., :gc], out[..., gc:]
        cond, uncond = eps[:n], eps[n:]
        guided = uncond + cfg_scale * (cond - uncond)
        return torch.cat([torch.cat([guided, guided], dim=0), rest], dim=-1)


def create_dit(model_type: str, *, img_resolution: int, in_channels: int = 4,
               label_dropout: float = 0.0, num_classes: Optional[int] = None,
               dtype: torch.dtype = torch.float32, use_flash: bool = False,
               remat: bool = False, remat_policy: Optional[str] = None,
               device: DeviceLike = None) -> DiT:
    """Factory matching the reference dispatch (models/__init__.py:12-17).
    The model is built on ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    depth, hidden, patch, heads = DIT_CONFIGS[model_type]
    with device:
        model = DiT(img_resolution=img_resolution, patch_size=patch,
                    in_channels=in_channels, hidden_size=hidden, depth=depth,
                    num_heads=heads, label_dropout=label_dropout,
                    num_classes=num_classes if num_classes is not None else 1,
                    dtype=dtype, use_flash=use_flash, remat=remat,
                    remat_policy=remat_policy)
    return model.to(device)
