"""Host-side datasets (the port's copy of part of lfm_tpu/data/datasets.py).

Every dataset yields ``(array_HWC_float32, label_int)``: images in [-1, 1],
or latents. The LMDB and image-folder readers wait for the host-data slice.
"""

from __future__ import annotations

import os

import numpy as np


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
