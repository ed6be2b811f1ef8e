"""Model factory: config -> velocity network (port of lfm_tpu/nn/factory.py,
reference models/__init__.py:6-70): ``use_origin_adm`` -> the ADM UNet,
DiT-* -> DiT. EDM's networks (DhariwalUNet, SongUNet) are not ported yet."""

from __future__ import annotations

from typing import Optional

import torch

from lfm_tpu_torch.core.config import ModelConfig
from lfm_tpu_torch.core.device import DeviceLike
from lfm_tpu_torch.nn.adm_unet import create_adm_unet
from lfm_tpu_torch.nn.dit import create_dit


def create_network(cfg: ModelConfig, *, dtype: torch.dtype = torch.float32,
                   use_flash: bool = False, remat: bool = False,
                   remat_policy: Optional[str] = None, use_fused_gn: bool = False,
                   device: DeviceLike = None):
    """The network of ``cfg`` on ``device`` (the card unless
    ``device="cpu"``). ``remat`` recomputes each DiT block in backward (grad
    checkpointing; the JAX package ignores it for the ADM UNet, as this
    does); ``use_fused_gn`` sends the ADM ResBlocks' GroupNorm + SiLU
    through the fused kernel."""
    if cfg.use_origin_adm:
        return create_adm_unet(cfg, dtype=dtype, use_flash=use_flash,
                               use_fused_gn=use_fused_gn, device=device)
    if cfg.is_dit:
        return create_dit(cfg.model_type, img_resolution=cfg.latent_size,
                          in_channels=cfg.num_in_channels,
                          label_dropout=cfg.label_dropout,
                          num_classes=cfg.num_classes, dtype=dtype,
                          use_flash=use_flash, remat=remat,
                          remat_policy=remat_policy, device=device)
    raise NotImplementedError(
        f"model_type {cfg.model_type!r} without use_origin_adm is EDM's network "
        "(DhariwalUNet / SongUNet), which is not ported yet")
