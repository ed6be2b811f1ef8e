"""Segmentation datasets for semantic-map-to-image synthesis (the port's
copy of lfm_tpu/data/segmentation.py).

The reference's albumentations pipelines (datasets_prep/coco.py:13-92,
ade20k.py, celeb_mask.py): a smallest-side resize (bicubic image, nearest
label map) and a center or random square crop. Datasets yield
``(image_HWC_float32_in[-1,1], seg_HW_int32)``; the semantic trainer
one-hots the map on the device (train_flow_latent_semantic_syn.py:174-176).
Class counts are the reference's (train_flow_latent_semantic_syn.py:91-99):
COCO-stuff 182 (183 shifted), ADE20k 151, CelebAMask 19.

The resize runs on torch where the JAX package calls ``cv2.resize``:
nearest is torch's ``nearest`` (OpenCV's INTER_NEAREST, bit for bit);
bicubic is torch's (a = -0.75, as OpenCV's INTER_CUBIC) on the uint8
values, rounded and clamped to uint8, within one level of OpenCV's.
Decoding a file needs Pillow, imported when an item is read.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lfm_tpu_torch.data.transforms import require_pil


def smallest_max_size(img: np.ndarray, size: int, nearest: bool = False) -> np.ndarray:
    """albumentations.SmallestMaxSize: the short side to ``size``, (H, W)
    or (H, W, C) uint8."""
    h, w = img.shape[:2]
    scale = size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = torch.from_numpy(img.astype(np.float32))
    x = (x[None, None] if img.ndim == 2 else x.permute(2, 0, 1)[None])
    if nearest:
        y = F.interpolate(x, size=(nh, nw), mode="nearest")
    else:
        y = F.interpolate(x, size=(nh, nw), mode="bicubic", align_corners=False)
        y = torch.clamp(torch.round(y), 0, 255)
    y = y[0, 0] if img.ndim == 2 else y[0].permute(1, 2, 0)
    return y.numpy().astype(img.dtype)


def square_crop(img: np.ndarray, seg: np.ndarray, size: int,
                random_crop: bool, rng: np.random.Generator):
    h, w = img.shape[:2]
    if random_crop:
        top = int(rng.integers(0, h - size + 1))
        left = int(rng.integers(0, w - size + 1))
    else:
        top, left = (h - size) // 2, (w - size) // 2
    return (img[top:top + size, left:left + size],
            seg[top:top + size, left:left + size])


class SegmentationBase:
    """(reference coco.py:13-92): csv of relative image paths; segmentation
    files mirror them with .png extension."""

    def __init__(self, data_csv: str, data_root: str, segmentation_root: str,
                 size: int = 256, random_crop: bool = False, n_labels: int = 182,
                 shift_segmentation: bool = False, seed: int = 0):
        with open(data_csv) as f:
            self.image_paths = f.read().splitlines()
        self.data_root = data_root
        self.segmentation_root = segmentation_root
        self.size = size
        self.random_crop = random_crop
        self.n_labels = n_labels
        self.num_classes = n_labels
        self.shift_segmentation = shift_segmentation
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.image_paths)

    def _seg_path(self, rel: str) -> str:
        return os.path.join(self.segmentation_root, rel.replace(".jpg", ".png"))

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        Image = require_pil("SegmentationBase")
        rel = self.image_paths[i]
        image = np.asarray(Image.open(os.path.join(self.data_root, rel)).convert("RGB"),
                           np.uint8)
        seg = np.asarray(Image.open(self._seg_path(rel)), np.uint8)
        if self.shift_segmentation:
            seg = seg.astype(np.int32) + 1  # unlabeled 255 -> 256? reference wraps uint8
            seg = (seg % 256).astype(np.uint8) if seg.max() > 255 else seg.astype(np.uint8)
        image = smallest_max_size(image, self.size)
        seg = smallest_max_size(seg, self.size, nearest=True)
        image, seg = square_crop(image, seg, self.size, self.random_crop, self.rng)
        img = image.astype(np.float32) / 127.5 - 1.0
        return img, seg.astype(np.int32)


class CocoStuff(SegmentationBase):
    """COCO-stuff segmentation (reference coco.py; 182/183 labels)."""

    def __init__(self, root: str, split: str = "train", size: int = 256,
                 random_crop: bool = False, seed: int = 0):
        super().__init__(
            data_csv=os.path.join(root, f"{split}.txt"),
            data_root=os.path.join(root, "images"),
            segmentation_root=os.path.join(root, "segmentations"),
            size=size, random_crop=random_crop, n_labels=183,
            shift_segmentation=True, seed=seed,
        )


class ADE20k(SegmentationBase):
    """ADE20k (reference ade20k.py; 151 labels incl. unknown)."""

    def __init__(self, root: str, split: str = "train", size: int = 256,
                 random_crop: bool = False, seed: int = 0):
        super().__init__(
            data_csv=os.path.join(root, f"{split}.txt"),
            data_root=os.path.join(root, "images"),
            segmentation_root=os.path.join(root, "annotations"),
            size=size, random_crop=random_crop, n_labels=151,
            shift_segmentation=False, seed=seed,
        )


class CelebAMask:
    """CelebAMask-HQ (reference celeb_mask.py:12-108): 27k train / 3k val,
    images ``{i}.jpg`` and rasterized masks ``{i}.png`` (19 classes incl.
    background; see preprocess_celeb_mask)."""

    CLASSES = [
        "background", "skin", "nose", "eye_g", "l_eye", "r_eye", "l_brow",
        "r_brow", "l_ear", "r_ear", "mouth", "u_lip", "l_lip", "hair", "hat",
        "ear_r", "neck_l", "neck", "cloth",
    ]

    def __init__(self, root: str, split: str = "train", size: int = 256,
                 random_crop: bool = False, seed: int = 0):
        self.image_root = os.path.join(root, "CelebA-HQ-img")
        self.mask_root = os.path.join(root, "mask")
        self.split = split
        self._length = 27000 if split == "train" else 3000
        self.size = size
        self.random_crop = random_crop
        self.num_classes = 19
        self.n_labels = 19
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self._length

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        Image = require_pil("CelebAMask")
        idx = i % 27000 if self.split == "train" else 27000 + (i % 3000)
        image = np.asarray(
            Image.open(os.path.join(self.image_root, f"{idx}.jpg")).convert("RGB"),
            np.uint8,
        )
        seg = np.asarray(Image.open(os.path.join(self.mask_root, f"{idx}.png")), np.uint8)
        image = smallest_max_size(image, self.size)
        seg = smallest_max_size(seg, self.size, nearest=True)
        image, seg = square_crop(image, seg, self.size, self.random_crop, self.rng)
        return image.astype(np.float32) / 127.5 - 1.0, seg.astype(np.int32)


def rasterize_celebamask_parts(anno_root: str, out_root: str, image_size: int = 512,
                               num_images: int = 30000):
    """Preprocessing tool (reference datasets_prep/preprocess_celeb_mask.py):
    combine the per-part binary masks of CelebAMask-HQ into one label map per
    image (class index = 1 + part order; 0 = background)."""
    Image = require_pil("rasterize_celebamask_parts")
    os.makedirs(out_root, exist_ok=True)
    parts = CelebAMask.CLASSES[1:]
    for idx in range(num_images):
        folder = idx // 2000
        label = np.zeros((image_size, image_size), np.uint8)
        for ci, part in enumerate(parts, start=1):
            p = os.path.join(anno_root, str(folder), f"{idx:05d}_{part}.png")
            if os.path.exists(p):
                m = np.asarray(Image.open(p).convert("L"))
                label[m > 128] = ci
        Image.fromarray(label).save(os.path.join(out_root, f"{idx}.png"))


def get_segmentation_dataset(name: str, root: str, size: int = 256,
                             split: str = "train", seed: int = 0):
    """Dispatch (train_flow_latent_semantic_syn.py:91-99)."""
    if name in ("coco", "coco_stuff"):
        return CocoStuff(root, split, size, random_crop=(split == "train"), seed=seed)
    if name == "ade20k":
        return ADE20k(root, split, size, random_crop=(split == "train"), seed=seed)
    if name in ("celebamask", "celeba_mask"):
        return CelebAMask(root, split, size, seed=seed)
    raise KeyError(f"unknown segmentation dataset {name!r}")
