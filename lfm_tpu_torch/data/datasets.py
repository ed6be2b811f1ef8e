"""Host-side datasets (the port's copy of lfm_tpu/data/datasets.py).

Framework-agnostic readers in place of the reference's torchvision
datasets (reference datasets_prep/__init__.py). Every dataset yields
``(array_HWC_float32, label_int)``: images in [-1, 1], or latents. The
LMDB readers are in ``lmdb_datasets.py``. Decoding an image file needs
Pillow, imported when an item is read.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Sequence, Tuple

import numpy as np

from lfm_tpu_torch.data.transforms import (center_crop_arr, maybe_flip, require_pil,
                                           resize_and_crop, resize_short_side, to_neg1_1)

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


class ImageFolderDataset:
    """Flat or class-subdir image folder (ImageNet-style when subdirs exist).

    transform_kind: 'adm_center_crop' (imagenet_256 pipeline,
    datasets_prep/__init__.py:25-37), 'resize' (celeba/ffhq: short-side
    resize only), or 'resize_crop' (LSUN: resize + center crop).
    """

    def __init__(self, root: str, image_size: int, transform_kind: str = "resize_crop",
                 random_flip: bool = True, seed: int = 0):
        self.root = root
        self.image_size = image_size
        self.transform_kind = transform_kind
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed)

        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.files: List[str] = []
        self.labels: List[int] = []
        if classes:
            for ci, c in enumerate(classes):
                cdir = os.path.join(root, c)
                for f in sorted(os.listdir(cdir)):
                    if f.lower().endswith(IMAGE_EXTS):
                        self.files.append(os.path.join(cdir, f))
                        self.labels.append(ci)
        else:
            for f in sorted(os.listdir(root)):
                if f.lower().endswith(IMAGE_EXTS):
                    self.files.append(os.path.join(root, f))
                    self.labels.append(0)
        self.num_classes = max(len(classes), 1)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        img = require_pil("ImageFolderDataset").open(self.files[i]).convert("RGB")
        if self.transform_kind == "adm_center_crop":
            img = center_crop_arr(img, self.image_size)
        elif self.transform_kind == "resize":
            img = resize_short_side(img, self.image_size)
        else:
            img = resize_and_crop(img, self.image_size)
        arr = to_neg1_1(np.asarray(img))
        if self.random_flip:
            arr = maybe_flip(arr, self.rng)
        return arr, self.labels[i]


class CIFAR10Dataset:
    """Reads the standard cifar-10-batches-py pickles (no torchvision, no
    Pillow)."""

    def __init__(self, root: str, train: bool = True, random_flip: bool = True, seed: int = 0):
        base = os.path.join(root, "cifar-10-batches-py")
        names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        xs, ys = [], []
        for n in names:
            with open(os.path.join(base, n), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        self.x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.y = np.asarray(ys, np.int32)
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed)
        self.num_classes = 10

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        arr = to_neg1_1(self.x[i])
        if self.random_flip:
            arr = maybe_flip(arr, self.rng)
        return arr, int(self.y[i])


class LatentDataset:
    """Pre-encoded latents stored as .npy ('latent_*' datasets,
    reference train_flow_latent.py:132,140-141: loader yields raw latents
    which the trainer multiplies by scale_factor)."""

    def __init__(self, path: str):
        self.z = np.load(os.path.join(path, "latents.npy"), mmap_mode="r")
        ypath = os.path.join(path, "labels.npy")
        self.y = np.load(ypath) if os.path.exists(ypath) else None
        self.num_classes = int(self.y.max()) + 1 if self.y is not None else 1

    def __len__(self):
        return len(self.z)

    def __getitem__(self, i):
        return np.asarray(self.z[i], np.float32), int(self.y[i]) if self.y is not None else 0


class SyntheticLatentDataset:
    """Deterministic random latents (latent-res, 4ch) for smoke runs without
    a VAE."""

    def __init__(self, n: int, latent_size: int, channels: int = 4,
                 num_classes: int = 1, seed: int = 0):
        self.n = n
        self.latent_size = latent_size
        self.channels = channels
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(self.seed * 99991 + i)
        z = rng.normal(size=(self.latent_size, self.latent_size,
                             self.channels)).astype(np.float32)
        return z, int(rng.integers(self.num_classes))


class SyntheticImageDataset:
    """Deterministic random images in [-1, 1] for tests and smoke runs."""

    def __init__(self, n: int, image_size: int, num_classes: int = 1, seed: int = 0):
        self.n = n
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(self.seed * 100003 + i)
        img = rng.uniform(-1, 1, (self.image_size, self.image_size, 3)).astype(np.float32)
        return img, int(rng.integers(self.num_classes))


class Subset:
    """(reference datasets_prep/__init__.py:50-65 LSUN 120k subsets)"""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)
        self.num_classes = getattr(dataset, "num_classes", 1)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]
