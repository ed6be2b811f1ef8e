"""Dataset registry (the port's copy of lfm_tpu/data/__init__.py; reference
datasets_prep/__init__.py:10-122).

The reference's dataset names and preprocessing: the image folders
(ImageNet with class subfolders, or any flat folder), CIFAR-10's pickles,
NVAE raw-RGB LMDBs (CelebA-HQ / FFHQ 256), multi-class LSUN LMDBs,
torchtoolbox image LMDBs (CelebA-HQ 512 / 1024), pre-encoded latents and
the synthetic sets. An LMDB-backed name also takes a plain image folder at
``datadir`` (``_folder_fallback``). ``get_inpainting_dataset`` gives the
inpainting task's images with LaMa masks. Every reader gives the JAX
package's arrays bit for bit.
"""

from __future__ import annotations

import os

from lfm_tpu_torch.core.config import Config
from lfm_tpu_torch.data.datasets import (CIFAR10Dataset, ImageFolderDataset, LatentDataset,
                                         Subset, SyntheticImageDataset,
                                         SyntheticLatentDataset)
from lfm_tpu_torch.data.loader import DataLoader
from lfm_tpu_torch.data.masks import get_mask_generator

__all__ = ["CIFAR10Dataset", "DataLoader", "ImageFolderDataset", "LatentDataset", "Subset",
           "SyntheticImageDataset", "SyntheticLatentDataset", "get_dataset",
           "get_inpainting_dataset", "get_mask_generator"]


def _folder_fallback(datadir: str) -> bool:
    """True when datadir holds plain images instead of an LMDB."""
    if not os.path.isdir(datadir):
        return False
    entries = os.listdir(datadir)
    return not any(e.endswith((".lmdb", ".mdb")) or e == "data.mdb" for e in entries)


def get_dataset(config: Config, seed: int = 0):
    name = config.dataset
    datadir = config.data.datadir
    size = config.model.image_size

    if name.startswith("latent_"):
        return LatentDataset(datadir)
    if name.startswith("synthetic"):
        if "latent" in name:
            return SyntheticLatentDataset(
                n=256, latent_size=config.model.latent_size,
                channels=config.model.num_in_channels,
                num_classes=config.model.num_classes or 1, seed=seed)
        return SyntheticImageDataset(n=256, image_size=size,
                                     num_classes=config.model.num_classes or 1, seed=seed)
    if name == "cifar10":
        return CIFAR10Dataset(datadir, train=True, seed=seed)
    if name == "imagenet_256":
        train_dir = os.path.join(datadir, "train")
        return ImageFolderDataset(train_dir if os.path.isdir(train_dir) else datadir,
                                  image_size=256, transform_kind="adm_center_crop", seed=seed)
    if name in ("lsun_church", "lsun_bedroom"):
        cls = "church_outdoor_train" if name == "lsun_church" else "bedroom_train"
        if _folder_fallback(datadir):
            ds = ImageFolderDataset(datadir, size, "resize_crop", seed=seed)
        else:
            from lfm_tpu_torch.data.lmdb_datasets import LSUN

            ds = LSUN(root=datadir, classes=[cls], image_size=size, seed=seed)
        # 120k subsets (reference datasets_prep/__init__.py:50-65)
        return Subset(ds, range(min(120_000, len(ds))))
    if name in ("celeba_256", "ffhq_256"):
        if _folder_fallback(datadir):
            return ImageFolderDataset(datadir, size, "resize", seed=seed)
        from lfm_tpu_torch.data.lmdb_datasets import LMDBDataset

        return LMDBDataset(root=datadir, name=name.split("_")[0], train=True, image_size=size,
                           seed=seed)
    if name in ("celeba_512", "celeba_1024"):
        if _folder_fallback(datadir):
            return ImageFolderDataset(datadir, size, "resize", seed=seed)
        from lfm_tpu_torch.data.lmdb_datasets import ImageLMDB

        return ImageLMDB(db_path=datadir, db_name=name, image_size=size, seed=seed)
    raise KeyError(f"unknown dataset {name!r}")


def get_inpainting_dataset(config: Config, seed: int = 0):
    """(reference datasets_prep/__init__.py:117-122): the images under
    ``datadir`` with LaMa's mixed masks."""
    from lfm_tpu_torch.data.inpainting import InpaintingTrainDataset

    return InpaintingTrainDataset(indir=config.data.datadir,
                                  mask_generator=get_mask_generator(None, None, seed=seed),
                                  image_size=config.model.image_size, seed=seed)
