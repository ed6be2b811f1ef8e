"""Datasets for training (the port's copy of part of lfm_tpu/data).

``get_dataset`` knows the synthetic and pre-encoded latent datasets; the
image-folder and LMDB readers of the reference's datasets (CelebA-HQ, FFHQ,
LSUN, ImageNet, CIFAR-10) wait for the host-data slice.
"""

from __future__ import annotations

from lfm_tpu_torch.core.config import Config
from lfm_tpu_torch.data.datasets import (LatentDataset, SyntheticImageDataset,
                                         SyntheticLatentDataset)
from lfm_tpu_torch.data.loader import DataLoader

__all__ = ["DataLoader", "LatentDataset", "SyntheticImageDataset", "SyntheticLatentDataset",
           "get_dataset"]


def get_dataset(config: Config, seed: int = 0):
    name = config.dataset
    if name.startswith("latent_"):
        return LatentDataset(config.data.datadir)
    if name.startswith("synthetic"):
        if "latent" in name:
            return SyntheticLatentDataset(
                n=256, latent_size=config.model.latent_size,
                channels=config.model.num_in_channels,
                num_classes=config.model.num_classes or 1, seed=seed)
        return SyntheticImageDataset(n=256, image_size=config.model.image_size,
                                     num_classes=config.model.num_classes or 1, seed=seed)
    raise NotImplementedError(
        f"dataset {name!r}: the image-folder and LMDB readers are not ported yet; "
        "pass dataset= or use a synthetic_* / latent_* dataset")
