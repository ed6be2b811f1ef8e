"""Annotated-object datasets for layout-to-image conditioning (the port's
copy of lfm_tpu/data/annotated_objects.py; reference
datasets_prep/annotated_objects_dataset.py:22-241, annotated_object_coco.py).

A COCO instances JSON becomes per-image ``Annotation`` lists with
crop-aware rescaling, and token conditionals from the objects_bbox and
objects_center_points builders (data/layout.py), which feed the layout UNet
through the token encoder. ``__getitem__`` returns {"image": HWC float32 in
[-1, 1], "objects_bbox": int64 tokens, "objects_center_points": int64
tokens, "crop_bbox", "flipped"}, the JAX package's values bit for bit.
Decoding an image needs Pillow, imported when an item is read
(``transforms.require_pil``).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from lfm_tpu_torch.data.layout import (
    Annotation,
    ObjectsBoundingBoxConditionalBuilder,
    ObjectsCenterPointsConditionalBuilder,
)
from lfm_tpu_torch.data.transforms import require_pil, resize_short_side, to_neg1_1


class AnnotatedObjectsCoco:
    def __init__(self, data_path: str, annotations_json: str, *,
                 target_image_size: int = 256, min_object_area: float = 0.00001,
                 max_objects_per_image: int = 30, no_tokens: int = 1024,
                 crop_method: str = "center", random_flip: bool = True,
                 encode_crop: bool = False, use_group_parameter: bool = True,
                 category_allow_list: Optional[List[str]] = None, seed: int = 0):
        self.data_path = data_path
        self.size = target_image_size
        self.crop_method = crop_method
        self.random_flip = random_flip
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)

        with open(annotations_json) as f:
            coco = json.load(f)

        cats = coco.get("categories", [])
        if category_allow_list:
            allow = set(category_allow_list)
            cats = [c for c in cats if c["name"] in allow]
        self.categories = {c["id"]: c["name"] for c in cats}
        self.category_number = {cid: i for i, cid in enumerate(sorted(self.categories))}
        self.no_classes = len(self.categories)

        images = {im["id"]: im for im in coco.get("images", [])}
        self.annotations: Dict[int, List[Annotation]] = {}
        for ann in coco.get("annotations", []):
            if ann["category_id"] not in self.categories:
                continue
            im = images.get(ann["image_id"])
            if im is None:
                continue
            w, h = im["width"], im["height"]
            x0, y0, bw, bh = ann["bbox"]  # absolute xywh
            rel = (x0 / w, y0 / h, bw / w, bh / h)
            area = ann.get("area", bw * bh) / (w * h)
            if area < min_object_area:
                continue
            self.annotations.setdefault(ann["image_id"], []).append(Annotation(
                bbox=rel, area=area, image_id=str(ann["image_id"]),
                category_no=self.category_number[ann["category_id"]],
                category_id=str(ann["category_id"]), id=str(ann.get("id", "")),
                is_group_of=bool(ann.get("iscrowd", 0)),
            ))
        # only images that still have annotations (reference:183-200)
        self.image_descriptions = [
            images[i] for i in sorted(self.annotations) if i in images
        ]
        self.max_objects_per_image = max_objects_per_image
        self.conditional_builders = {
            "objects_center_points": ObjectsCenterPointsConditionalBuilder(
                self.no_classes, max_objects_per_image, no_tokens,
                encode_crop, use_group_parameter, False),
            "objects_bbox": ObjectsBoundingBoxConditionalBuilder(
                self.no_classes, max_objects_per_image, no_tokens,
                encode_crop, use_group_parameter, False),
        }

    def __len__(self):
        return len(self.image_descriptions)

    def _crop(self, arr: np.ndarray) -> Tuple[Tuple[float, float, float, float], np.ndarray]:
        """Square crop returning relative crop bbox (reference crop-with-
        coordinates transforms, image_transforms.py:23-133)."""
        h, w = arr.shape[:2]
        s = self.size
        if self.crop_method == "random-1d":
            top = int(self.np_rng.integers(0, h - s + 1))
            left = int(self.np_rng.integers(0, w - s + 1))
        else:  # center
            top, left = (h - s) // 2, (w - s) // 2
        crop_bbox = (left / w, top / h, s / w, s / h)
        return crop_bbox, arr[top:top + s, left:left + s]

    def __getitem__(self, n: int) -> Dict:
        Image = require_pil("AnnotatedObjectsCoco's images")
        desc = self.image_descriptions[n]
        fname = desc.get("file_name", f"{desc['id']:012d}.jpg")
        img = Image.open(os.path.join(self.data_path, fname)).convert("RGB")
        img = resize_short_side(img, self.size)
        arr = np.asarray(img, np.uint8)
        crop_bbox, arr = self._crop(arr)
        flipped = self.random_flip and self.np_rng.random() < 0.5
        if flipped:
            arr = arr[:, ::-1]
        anns = self.annotations[desc["id"]]
        out = {"image": to_neg1_1(arr), "crop_bbox": crop_bbox, "flipped": flipped}
        for name, builder in self.conditional_builders.items():
            out[name] = builder.build(list(anns), crop_coordinates=crop_bbox,
                                      horizontal_flip=flipped, rng=self.rng)
        return out
