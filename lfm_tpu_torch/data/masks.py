"""LaMa-style inpainting mask generation on the host (the port's copy of
lfm_tpu/data/masks.py).

The reference's vendored mask generator
(datasets_prep/inpaint_preprocess/mask.py:15-380): random irregular brush
strokes (LINE / SQUARE draw methods), random rectangles, super-resolution
grids, mixed with the same default probabilities (irregular 1/2, box 1/2),
and the LinearRamp curriculum, drawing from ``np.random.Generator`` in the
JAX package's order. Masks are (H, W) float32 with 1 = hole.

A LINE stroke is drawn by the JAX package's own numpy fallback (squares
stamped along the segment), never by ``cv2.line``, which the reference
and the JAX package use where OpenCV is installed: a stroke's edge pixels
differ from OpenCV's (ROADMAP Queue 3), and with OpenCV absent the masks
equal the JAX package's bit for bit.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional, Tuple

import numpy as np


class DrawMethod(Enum):
    LINE = "line"
    CIRCLE = "circle"
    SQUARE = "square"


class LinearRamp:
    """(reference mask.py:15-28)"""

    def __init__(self, start_value=0, end_value=1, start_iter=-1, end_iter=0):
        self.start_value = start_value
        self.end_value = end_value
        self.start_iter = start_iter
        self.end_iter = end_iter

    def __call__(self, i):
        if i < self.start_iter:
            return self.start_value
        if i >= self.end_iter:
            return self.end_value
        part = (i - self.start_iter) / (self.end_iter - self.start_iter)
        return self.start_value * (1 - part) + self.end_value * part


def _line(mask: np.ndarray, p0, p1, width: int):
    """Squares of side 2 * max(width // 2, 1) stamped along the segment
    (lfm_tpu/data/masks.py:49-57)."""
    x0, y0 = p0
    x1, y1 = p1
    n = max(abs(x1 - x0), abs(y1 - y0), 1)
    r = max(width // 2, 1)
    h, w = mask.shape
    for s in range(n + 1):
        x = int(round(x0 + (x1 - x0) * s / n))
        y = int(round(y0 + (y1 - y0) * s / n))
        mask[max(0, y - r):min(h, y + r), max(0, x - r):min(w, x + r)] = 1.0


def make_random_irregular_mask(
    shape: Tuple[int, int], max_angle=4, max_len=60, max_width=20,
    min_times=0, max_times=10, draw_method=DrawMethod.LINE,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """(reference mask.py:37-64)"""
    rng = rng or np.random.default_rng()
    h, w = shape
    mask = np.zeros((h, w), np.float32)
    times = rng.integers(min_times, max_times + 1)
    for i in range(times):
        sx = int(rng.integers(w))
        sy = int(rng.integers(h))
        for _ in range(1 + int(rng.integers(5))):
            angle = 0.01 + rng.integers(max_angle)
            if i % 2 == 0:
                angle = 2 * 3.1415926 - angle
            length = 10 + int(rng.integers(max_len))
            brush = 5 + int(rng.integers(max_width))
            ex = int(np.clip(sx + length * np.sin(angle), 0, w))
            ey = int(np.clip(sy + length * np.cos(angle), 0, h))
            if draw_method == DrawMethod.LINE:
                _line(mask, (sx, sy), (ex, ey), brush)
            elif draw_method == DrawMethod.SQUARE:
                r = brush // 2
                mask[max(0, sy - r):sy + r, max(0, sx - r):sx + r] = 1
            else:
                raise NotImplementedError(draw_method)
            sx, sy = ex, ey
    return mask


def make_random_rectangle_mask(
    shape: Tuple[int, int], margin=10, bbox_min_size=30, bbox_max_size=100,
    min_times=0, max_times=3, rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """(reference mask.py:102-113)"""
    rng = rng or np.random.default_rng()
    h, w = shape
    mask = np.zeros((h, w), np.float32)
    bbox_max_size = min(bbox_max_size, h - margin * 2, w - margin * 2)
    for _ in range(int(rng.integers(min_times, max_times + 1))):
        bw = int(rng.integers(bbox_min_size, bbox_max_size))
        bh = int(rng.integers(bbox_min_size, bbox_max_size))
        sx = int(rng.integers(margin, w - margin - bw + 1))
        sy = int(rng.integers(margin, h - margin - bh + 1))
        mask[sy:sy + bh, sx:sx + bw] = 1
    return mask


def make_random_superres_mask(
    shape: Tuple[int, int], min_step=2, max_step=4, min_width=1, max_width=3,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """(reference mask.py:153-168)"""
    rng = rng or np.random.default_rng()
    h, w = shape
    mask = np.zeros((h, w), np.float32)
    step_x = int(rng.integers(min_step, max_step + 1))
    width_x = int(rng.integers(min_width, min(step_x, max_width + 1)))
    off_x = int(rng.integers(0, step_x))
    step_y = int(rng.integers(min_step, max_step + 1))
    width_y = int(rng.integers(min_width, min(step_y, max_width + 1)))
    off_y = int(rng.integers(0, step_y))
    for dy in range(width_y):
        mask[off_y + dy::step_y] = 1
    for dx in range(width_x):
        mask[:, off_x + dx::step_x] = 1
    return mask


class RandomIrregularMaskGenerator:
    def __init__(self, max_angle=4, max_len=60, max_width=20, min_times=0,
                 max_times=10, ramp_kwargs=None, draw_method=DrawMethod.LINE,
                 seed: Optional[int] = None):
        self.kw = dict(max_angle=max_angle, max_len=max_len, max_width=max_width,
                       min_times=min_times, max_times=max_times)
        self.draw_method = draw_method
        self.ramp = LinearRamp(**ramp_kwargs) if ramp_kwargs else None
        self.rng = np.random.default_rng(seed)

    def __call__(self, shape: Tuple[int, int], iter_i=None) -> np.ndarray:
        coef = self.ramp(iter_i) if (self.ramp and iter_i is not None) else 1
        kw = dict(self.kw)
        kw["max_len"] = int(max(1, kw["max_len"] * coef))
        kw["max_width"] = int(max(1, kw["max_width"] * coef))
        kw["max_times"] = int(kw["min_times"] + 1 + (kw["max_times"] - kw["min_times"]) * coef)
        return make_random_irregular_mask(shape, draw_method=self.draw_method,
                                          rng=self.rng, **kw)


class RandomRectangleMaskGenerator:
    def __init__(self, margin=10, bbox_min_size=30, bbox_max_size=100,
                 min_times=0, max_times=3, ramp_kwargs=None, seed=None):
        self.kw = dict(margin=margin, bbox_min_size=bbox_min_size,
                       bbox_max_size=bbox_max_size, min_times=min_times,
                       max_times=max_times)
        self.ramp = LinearRamp(**ramp_kwargs) if ramp_kwargs else None
        self.rng = np.random.default_rng(seed)

    def __call__(self, shape: Tuple[int, int], iter_i=None) -> np.ndarray:
        coef = self.ramp(iter_i) if (self.ramp and iter_i is not None) else 1
        kw = dict(self.kw)
        kw["bbox_max_size"] = int(
            kw["bbox_min_size"] + 1 + (kw["bbox_max_size"] - kw["bbox_min_size"]) * coef
        )
        kw["max_times"] = int(kw["min_times"] + (kw["max_times"] - kw["min_times"]) * coef)
        return make_random_rectangle_mask(shape, rng=self.rng, **kw)


class RandomSuperresMaskGenerator:
    def __init__(self, seed=None, **kw):
        self.kw = kw
        self.rng = np.random.default_rng(seed)

    def __call__(self, shape: Tuple[int, int], iter_i=None) -> np.ndarray:
        return make_random_superres_mask(shape, rng=self.rng, **self.kw)


class MixedMaskGenerator:
    """(reference mask.py:293-367) with the same default mix."""

    def __init__(self, irregular_proba=0.5, irregular_kwargs=None,
                 box_proba=0.5, box_kwargs=None, superres_proba=0,
                 superres_kwargs=None, invert_proba=0, seed: Optional[int] = None):
        self.rng = np.random.default_rng(seed)
        self.probas, self.gens = [], []
        if irregular_proba > 0:
            self.probas.append(irregular_proba)
            kw = dict(irregular_kwargs or {})
            kw["draw_method"] = DrawMethod.LINE
            kw.setdefault("seed", seed)
            self.gens.append(RandomIrregularMaskGenerator(**kw))
        if box_proba > 0:
            self.probas.append(box_proba)
            kw = dict(box_kwargs or {})
            kw.setdefault("seed", seed)
            self.gens.append(RandomRectangleMaskGenerator(**kw))
        if superres_proba > 0:
            self.probas.append(superres_proba)
            kw = dict(superres_kwargs or {})
            kw.setdefault("seed", seed)
            self.gens.append(RandomSuperresMaskGenerator(**kw))
        p = np.asarray(self.probas, np.float64)
        self.probas = p / p.sum()
        self.invert_proba = invert_proba

    def __call__(self, shape: Tuple[int, int], iter_i=None) -> np.ndarray:
        kind = int(self.rng.choice(len(self.probas), p=self.probas))
        mask = self.gens[kind](shape, iter_i=iter_i)
        if self.invert_proba > 0 and self.rng.random() < self.invert_proba:
            mask = 1 - mask
        return mask


def get_mask_generator(kind: Optional[str] = None, kwargs: Optional[dict] = None,
                       seed: Optional[int] = None):
    """(reference mask.py:368-380)"""
    kind = kind or "mixed"
    kwargs = kwargs or {}
    if kind == "mixed":
        return MixedMaskGenerator(seed=seed, **kwargs)
    raise NotImplementedError(f"No such generator kind = {kind}")
