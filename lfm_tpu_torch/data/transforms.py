"""Host-side image transforms (the port's copy of lfm_tpu/data/transforms.py).

Equivalents of the reference's torchvision pipelines (reference
datasets_prep/__init__.py:10-114, data_transforms.py:5-19) on numpy and
Pillow. All outputs are HWC float32 in [-1, 1] (the Normalize(0.5, 0.5)
convention), uint8 up to ``to_neg1_1``, so they equal the JAX package's bit
for bit. Pillow is imported only where an image is decoded or resampled
(``require_pil``), never at import time: the card's machine may lack it.
"""

from __future__ import annotations

import numpy as np


def require_pil(what: str):
    """``PIL.Image``, or an ImportError that says ``what`` needs Pillow."""
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError(f"{what} needs Pillow (PIL), which is not installed; raw NVAE LMDB "
                          "records already at the image size and the .npy / latent "
                          "datasets need no Pillow") from err
    return Image


def center_crop_arr(pil_image, image_size: int):
    """ADM center-crop (reference data_transforms.py:5-19): BOX-downsample by
    2 while min side >= 2*size, BICUBIC to scale, center crop."""
    Image = require_pil("center_crop_arr")
    while min(*pil_image.size) >= 2 * image_size:
        pil_image = pil_image.resize(tuple(x // 2 for x in pil_image.size), resample=Image.BOX)
    scale = image_size / min(*pil_image.size)
    pil_image = pil_image.resize(tuple(round(x * scale) for x in pil_image.size),
                                 resample=Image.BICUBIC)
    arr = np.array(pil_image)
    cy = (arr.shape[0] - image_size) // 2
    cx = (arr.shape[1] - image_size) // 2
    return Image.fromarray(arr[cy:cy + image_size, cx:cx + image_size])


def resize_short_side(pil_image, size: int):
    """torchvision transforms.Resize(size): short side -> size, bilinear."""
    Image = require_pil("resize_short_side")
    w, h = pil_image.size
    if w <= h:
        nw, nh = size, max(1, round(h * size / w))
    else:
        nh, nw = size, max(1, round(w * size / h))
    return pil_image.resize((nw, nh), resample=Image.BILINEAR)


def center_crop(pil_image, size: int):
    w, h = pil_image.size
    left = (w - size) // 2
    top = (h - size) // 2
    return pil_image.crop((left, top, left + size, top + size))


def to_neg1_1(arr: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [-1, 1]."""
    return arr.astype(np.float32) / 127.5 - 1.0


def maybe_flip(arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """RandomHorizontalFlip(p=0.5) on an HWC array."""
    if rng.random() < 0.5:
        return arr[:, ::-1].copy()
    return arr


def resize_and_crop(pil_image, size: int, crop: bool = True):
    img = resize_short_side(pil_image, size)
    if crop:
        img = center_crop(img, size)
    return img
