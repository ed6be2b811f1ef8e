"""Model factory: config -> velocity network (port of lfm_tpu/nn/factory.py).
Only the DiT branch is ported; ADM and EDM come with their slice."""

from __future__ import annotations

from typing import Optional

import torch

from lfm_tpu_torch.core.config import ModelConfig
from lfm_tpu_torch.core.device import DeviceLike
from lfm_tpu_torch.nn.dit import create_dit


def create_network(cfg: ModelConfig, *, dtype: torch.dtype = torch.float32,
                   use_flash: bool = False, remat: bool = False,
                   remat_policy: Optional[str] = None, device: DeviceLike = None):
    """DiT-* -> DiT on ``device`` (the card unless ``device="cpu"``);
    ``remat`` recomputes each block in backward (grad checkpointing)."""
    if cfg.is_dit and not cfg.use_origin_adm:
        return create_dit(cfg.model_type, img_resolution=cfg.latent_size,
                          in_channels=cfg.num_in_channels,
                          label_dropout=cfg.label_dropout,
                          num_classes=cfg.num_classes, dtype=dtype,
                          use_flash=use_flash, remat=remat,
                          remat_policy=remat_policy, device=device)
    raise NotImplementedError(
        f"model_type {cfg.model_type!r}: only the DiT family is ported yet")
