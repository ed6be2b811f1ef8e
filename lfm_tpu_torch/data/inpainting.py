"""Inpainting training dataset (the port's copy of lfm_tpu/data/inpainting.py;
reference datasets_prep/inpainting_dataset.py:10-34).

Yields (image, mask, masked): the image HWC in [-1, 1], the mask (H, W, 1)
with 1 = hole, masked = image * (1 - mask), bit for bit as the JAX
package's. Decoding a file needs Pillow (``_image``, imported when an item
is read); a subclass that overrides ``_image`` needs none.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from lfm_tpu_torch.data.datasets import IMAGE_EXTS
from lfm_tpu_torch.data.transforms import maybe_flip, require_pil, resize_and_crop, to_neg1_1


class InpaintingTrainDataset:
    def __init__(self, indir: str, mask_generator, image_size: int = 256,
                 random_flip: bool = True, seed: int = 0):
        self.files = []
        for root, _, files in os.walk(indir):
            for f in sorted(files):
                if f.lower().endswith(IMAGE_EXTS):
                    self.files.append(os.path.join(root, f))
        self.mask_generator = mask_generator
        self.image_size = image_size
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed)
        self.iter_i = 0
        self.num_classes = 1

    def __len__(self):
        return len(self.files)

    def _image(self, i: int) -> np.ndarray:
        """Item i as uint8 (image_size, image_size, 3)."""
        img = require_pil("InpaintingTrainDataset").open(self.files[i]).convert("RGB")
        return np.asarray(resize_and_crop(img, self.image_size))

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        arr = to_neg1_1(self._image(i))
        if self.random_flip:
            arr = maybe_flip(arr, self.rng)
        mask = self.mask_generator((self.image_size, self.image_size),
                                   iter_i=self.iter_i)[..., None].astype(np.float32)
        self.iter_i += 1
        masked = arr * (1.0 - mask)
        return arr, mask, masked
