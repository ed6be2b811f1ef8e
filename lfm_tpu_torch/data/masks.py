"""LaMa-style inpainting mask generation on the host (the port's copy of
lfm_tpu/data/masks.py).

The reference's vendored mask generator
(datasets_prep/inpaint_preprocess/mask.py:15-380): random irregular brush
strokes (LINE / SQUARE draw methods), random rectangles, super-resolution
grids, mixed with the same default probabilities (irregular 1/2, box 1/2),
and the LinearRamp curriculum, drawing from ``np.random.Generator`` in the
JAX package's order. Masks are (H, W) float32 with 1 = hole.

A LINE stroke is ``cv2.line(mask, p0, p1, 1.0, width)``, which the
reference and the JAX package draw where OpenCV is installed, rasterised
here in plain Python (the card's machine has no OpenCV) by OpenCV's own
integer steps for a thick 8-connected line (imgproc/drawing.cpp): the
segment clipped to the image grown by the width on each side, its ends in
16.16 fixed point, the four corners offset by the rounded normal and
filled as a convex polygon (its edges traced, then scan lines), and a
filled circle at each end. The masks equal the JAX package's with OpenCV
present bit for bit.
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


# OpenCV's fixed point for drawing (imgproc/drawing.cpp: XY_SHIFT)
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
HALF = XY_ONE >> 1


def _cdiv(a: int, b: int) -> int:
    """C's integer division, which truncates toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, p1, p2):
    """``clipLine``: the segment clipped to [0, w - 1] x [0, h - 1], or None
    where it misses; the intersections truncated toward zero as C does."""
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _put(mask: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> None:
    """mask[ys, xs] = 1 where (xs, ys) lies in the image."""
    keep = (xs >= 0) & (xs < mask.shape[1]) & (ys >= 0) & (ys < mask.shape[0])
    mask[ys[keep], xs[keep]] = 1.0


def _edge(mask: np.ndarray, p1, p2) -> None:
    """``Line2``: the 8-connected line between two fixed-point points,
    clipped to the image, stepping one pixel along the longer axis."""
    h, w = mask.shape
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    x_major = abs(x2 - x1) > abs(y2 - y1)
    if (x2 < x1) if x_major else (y2 < y1):
        x1, y1, x2, y2 = x2, y2, x1, y1
    _put(mask, np.array([(x2 + HALF) >> XY_SHIFT]), np.array([(y2 + HALF) >> XY_SHIFT]))
    if x_major:
        step = _cdiv((y2 - y1) << XY_SHIFT, (x2 - x1) | 1)
        k = np.arange(((x2 - x1) >> XY_SHIFT) + 1, dtype=np.int64)
        _put(mask, ((x1 + HALF) >> XY_SHIFT) + k, (y1 + HALF + k * step) >> XY_SHIFT)
    else:
        step = _cdiv((x2 - x1) << XY_SHIFT, (y2 - y1) | 1)
        k = np.arange(((y2 - y1) >> XY_SHIFT) + 1, dtype=np.int64)
        _put(mask, (x1 + HALF + k * step) >> XY_SHIFT, ((y1 + HALF) >> XY_SHIFT) + k)


def _fill_convex_poly(mask: np.ndarray, v) -> None:
    """``FillConvexPoly`` of fixed-point corners for an 8-connected line:
    the edges traced, then each scan line filled between its two edges,
    whose x steps by a rounded slope from the upper corner."""
    h, w = mask.shape
    n = len(v)
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    for i in range(n):
        _edge(mask, v[i - 1], v[i])
    xmin = (min(p[0] for p in v) + HALF) >> XY_SHIFT
    xmax = (max(p[0] for p in v) + HALF) >> XY_SHIFT
    ymin = (min(ys) + HALF) >> XY_SHIFT
    ymax = (max(ys) + HALF) >> XY_SHIFT
    if xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    idx, step = [imin, imin], [1, n - 1]
    ye, x, dx = [ymin, ymin], [-XY_ONE, -XY_ONE], [0, 0]
    y = ymin
    while True:
        for e in range(2):
            if y < ye[e]:
                continue
            i0 = idx[e]
            i1 = (i0 + step[e]) % n
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (v[i1][1] + HALF) >> XY_SHIFT
                if ty > y:
                    ye[e], x[e], idx[e] = ty, v[i0][0], i1
                    dx[e] = _cdiv((v[i1][0] - v[i0][0]) * 2 + (ty - y), 2 * (ty - y))
                    break
                i0, i1 = i1, (i1 + step[e]) % n
        if edges < 0:
            break
        if y >= 0:
            x1 = (min(x) + HALF) >> XY_SHIFT
            x2 = (max(x) + HALF) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                mask[y, max(x1, 0):min(x2, w - 1) + 1] = 1.0
        x = [x[0] + dx[0], x[1] + dx[1]]
        y += 1
        if y > ymax:
            break


def _disc(mask: np.ndarray, cx: int, cy: int, radius: int) -> None:
    """``Circle`` filled: the midpoint circle's spans, clipped."""
    h, w = mask.shape
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for y, x1, x2 in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= y < h and x1 < w and x2 >= 0:
                mask[y, max(x1, 0):min(x2, w - 1) + 1] = 1.0
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def _line(mask: np.ndarray, p0, p1, width: int) -> None:
    """``cv2.line(mask, p0, p1, 1.0, width)``, ``LINE_8``, for width >= 2."""
    if width < 2:
        raise ValueError(f"a stroke is at least 2 pixels wide, got {width}")
    h, w = mask.shape
    clipped = _clip_line(w + 2 * width, h + 2 * width, (p0[0] + width, p0[1] + width),
                         (p1[0] + width, p1[1] + width))
    if clipped is None:
        return
    (x0, y0), (x1, y1) = [(x - width, y - width) for x, y in clipped]
    p0, p1 = (x0 << XY_SHIFT, y0 << XY_SHIFT), (x1 << XY_SHIFT, y1 << XY_SHIFT)
    ddx, ddy = (p0[0] - p1[0]) / XY_ONE, (p1[1] - p0[1]) / XY_ONE
    r = ddx * ddx + ddy * ddy
    half_width = width << (XY_SHIFT - 1)
    if r > np.finfo(np.float64).eps:
        r = (half_width + (width & 1) * XY_ONE * 0.5) / np.sqrt(r)
        nx, ny = int(np.rint(ddy * r)), int(np.rint(ddx * r))  # cvRound
        _fill_convex_poly(mask, [(p0[0] + nx, p0[1] + ny), (p0[0] - nx, p0[1] - ny),
                                 (p1[0] - nx, p1[1] - ny), (p1[0] + nx, p1[1] + ny)])
    radius = (half_width + HALF) >> XY_SHIFT
    for px, py in (p0, p1):
        _disc(mask, (px + HALF) >> XY_SHIFT, (py + HALF) >> XY_SHIFT, radius)


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
