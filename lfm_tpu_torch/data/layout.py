"""Layout-to-image conditional builders (the port's copy of
lfm_tpu/data/layout.py; reference datasets_prep/conditional_builder/
{objects_center_points,objects_bbox,utils}.py, helper_types.py:1-51).

Object annotations become fixed-length token sequences: per object a class
token and either one centre-coordinate token or a (top-left,
bottom-right) token pair, padded with a ``none`` token, and optionally two
crop tokens. Coordinates are tokenised on a sqrt(no_tokens) x
sqrt(no_tokens) grid (objects_center_points.py:62-92). Host numpy, the
JAX package's arithmetic: the same annotations, crop, flip and
``random.Random`` give the same tokens. These sequences feed the layout
UNet (nn/adm_unet.py ``use_spatial_transformer``) through the token
encoder (nn/text_encoder.py).
"""

from __future__ import annotations

import dataclasses
import math
import random
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np

BoundingBox = Tuple[float, float, float, float]  # x0, y0, w, h (relative)
FULL_CROP: BoundingBox = (0.0, 0.0, 1.0, 1.0)


@dataclasses.dataclass
class Annotation:
    """(reference helper_types.py): one object instance."""

    bbox: Optional[BoundingBox] = None
    category_no: int = 0
    area: Optional[float] = None
    image_id: Optional[str] = None
    category_id: Optional[str] = None
    id: Optional[str] = None
    source: Optional[str] = None
    confidence: Optional[float] = None
    is_group_of: bool = False
    is_occluded: bool = False
    is_depiction: bool = False
    is_inside: bool = False


def intersection_area(r1: BoundingBox, r2: BoundingBox) -> float:
    dx = min(r1[0] + r1[2], r2[0] + r2[2]) - max(r1[0], r2[0])
    dy = min(r1[1] + r1[3], r2[1] + r2[3]) - max(r1[1], r2[1])
    return dx * dy if (dx > 0 and dy > 0) else 0.0


def horizontally_flip_bbox(bbox: BoundingBox) -> BoundingBox:
    return (1.0 - (bbox[0] + bbox[2]), bbox[1], bbox[2], bbox[3])


def absolute_bbox(rel: BoundingBox, width: int, height: int):
    x0, y0, w, h = rel
    return int(x0 * width), int(y0 * height), int((x0 + w) * width), int((y0 + h) * height)


def pad_list(lst: List, pad, length: int) -> List:
    return lst + [pad] * (length - len(lst))


def filter_annotations(annotations: Sequence[Annotation], crop: BoundingBox):
    """Keep objects with >=25% area inside the crop
    (reference conditional_builder/utils.py:71-72)."""
    return [a for a in annotations if intersection_area(a.bbox, crop) > 0.25 * a.area]


def rescale_annotations(annotations: Sequence[Annotation], crop: BoundingBox,
                        flip: bool) -> List[Annotation]:
    """(reference utils.py:55-68): express bboxes relative to the crop, clamp
    to [0,1], optionally mirror."""

    def clamp(v):
        return min(max(v, 0.0), 1.0)

    out = []
    for a in annotations:
        x0 = clamp((a.bbox[0] - crop[0]) / crop[2])
        y0 = clamp((a.bbox[1] - crop[1]) / crop[3])
        w = min(a.bbox[2] / crop[2], 1.0 - x0)
        h = min(a.bbox[3] / crop[3], 1.0 - y0)
        bbox = (x0, y0, w, h)
        if flip:
            bbox = horizontally_flip_bbox(bbox)
        out.append(dataclasses.replace(a, bbox=bbox))
    return out


class ObjectsCenterPointsConditionalBuilder:
    """(reference objects_center_points.py:31-210)"""

    def __init__(self, no_object_classes: int, no_max_objects: int, no_tokens: int,
                 encode_crop: bool = False, use_group_parameter: bool = False,
                 use_additional_parameters: bool = False):
        self.no_object_classes = no_object_classes
        self.no_max_objects = no_max_objects
        self.no_tokens = no_tokens
        self.encode_crop = encode_crop
        self.no_sections = int(math.sqrt(no_tokens))
        self.use_group_parameter = use_group_parameter
        self.use_additional_parameters = use_additional_parameters

    @property
    def none(self) -> int:
        return self.no_tokens - 1

    @property
    def object_descriptor_length(self) -> int:
        return 2

    @property
    def embedding_dim(self) -> int:
        return self.no_max_objects * self.object_descriptor_length + (
            2 if self.encode_crop else 0
        )

    def tokenize_coordinates(self, x: float, y: float) -> int:
        xd = int(round(x * (self.no_sections - 1)))
        yd = int(round(y * (self.no_sections - 1)))
        return yd * self.no_sections + xd

    def coordinates_from_token(self, token: int) -> Tuple[float, float]:
        x = token % self.no_sections
        y = token // self.no_sections
        return x / (self.no_sections - 1), y / (self.no_sections - 1)

    def bbox_from_token_pair(self, t1: int, t2: int) -> BoundingBox:
        x0, y0 = self.coordinates_from_token(t1)
        x1, y1 = self.coordinates_from_token(t2)
        return x0, y0, x1 - x0, y1 - y0

    def token_pair_from_bbox(self, bbox: BoundingBox) -> Tuple[int, int]:
        return (
            self.tokenize_coordinates(bbox[0], bbox[1]),
            self.tokenize_coordinates(bbox[0] + bbox[2], bbox[1] + bbox[3]),
        )

    def object_representation(self, a: Annotation) -> int:
        modifier = 0
        if self.use_group_parameter:
            modifier |= 1 * (a.is_group_of is True)
        if self.use_additional_parameters:
            modifier |= 2 * (a.is_occluded is True)
            modifier |= 4 * (a.is_depiction is True)
            modifier |= 8 * (a.is_inside is True)
        return a.category_no + self.no_object_classes * modifier

    def representation_to_annotation(self, representation: int) -> Annotation:
        category_no = representation % self.no_object_classes
        modifier = representation // self.no_object_classes
        return Annotation(
            category_no=category_no,
            is_group_of=bool((modifier & 1) and self.use_group_parameter),
            is_occluded=bool((modifier & 2) and self.use_additional_parameters),
            is_depiction=bool((modifier & 4) and self.use_additional_parameters),
            is_inside=bool((modifier & 8) and self.use_additional_parameters),
        )

    def _make_object_descriptors(self, annotations: List[Annotation]):
        tuples = [
            (self.object_representation(a),
             self.tokenize_coordinates(a.bbox[0] + a.bbox[2] / 2,
                                       a.bbox[1] + a.bbox[3] / 2))
            for a in annotations
        ]
        return pad_list(tuples, (self.none, self.none), self.no_max_objects)

    def build(self, annotations: List[Annotation],
              crop_coordinates: Optional[BoundingBox] = None,
              horizontal_flip: bool = False,
              rng: Optional[random.Random] = None) -> np.ndarray:
        if len(annotations) == 0:
            warnings.warn("Did not receive any annotations.")
        if len(annotations) > self.no_max_objects:
            warnings.warn("Received more annotations than allowed.")
            annotations = list(annotations)[: self.no_max_objects]
        crop = crop_coordinates or FULL_CROP
        annotations = list(annotations)
        (rng or random).shuffle(annotations)
        annotations = filter_annotations(annotations, crop)
        if self.encode_crop:
            annotations = rescale_annotations(annotations, FULL_CROP, horizontal_flip)
            if horizontal_flip:
                crop = horizontally_flip_bbox(crop)
            extra = list(self.token_pair_from_bbox(crop))
        else:
            annotations = rescale_annotations(annotations, crop, horizontal_flip)
            extra = []
        tuples = self._make_object_descriptors(annotations)
        flat = [t for tup in tuples for t in tup] + extra
        assert len(flat) == self.embedding_dim
        assert all(0 <= v < self.no_tokens for v in flat)
        return np.asarray(flat, np.int64)

    def inverse_build(self, conditional: np.ndarray):
        lst = list(np.asarray(conditional).tolist())
        crop = None
        if self.encode_crop:
            crop = self.bbox_from_token_pair(lst[-2], lst[-1])
            lst = lst[:-2]
        k = self.object_descriptor_length
        groups = [tuple(lst[i:i + k]) for i in range(0, len(lst), k)]
        return [
            (g[0], self.coordinates_from_token(g[1]))
            for g in groups if g[0] != self.none
        ], crop


class ObjectsBoundingBoxConditionalBuilder(ObjectsCenterPointsConditionalBuilder):
    """(reference objects_bbox.py:24-49): class token + (tl, br) token pair."""

    @property
    def object_descriptor_length(self) -> int:
        return 3

    def _make_object_descriptors(self, annotations: List[Annotation]):
        triples = [
            (self.object_representation(a), *self.token_pair_from_bbox(a.bbox))
            for a in annotations
        ]
        return pad_list(triples, (self.none,) * 3, self.no_max_objects)

    def inverse_build(self, conditional: np.ndarray):
        lst = list(np.asarray(conditional).tolist())
        crop = None
        if self.encode_crop:
            crop = self.bbox_from_token_pair(lst[-2], lst[-1])
            lst = lst[:-2]
        groups = [tuple(lst[i:i + 3]) for i in range(0, len(lst), 3)]
        return [
            (g[0], self.bbox_from_token_pair(g[1], g[2]))
            for g in groups if g[0] != self.none
        ], crop
