"""Inpainting metrics: FID and P-IDS / U-IDS (port of
lfm_tpu/eval/inpainting_metrics.py; reference pytorch_fid/cal_inpainting.py).

P-IDS / U-IDS (paired / unpaired Inception discriminative score,
CoModGAN): a linear SVM separates real from fake pool3 activations; U-IDS
= 1 - its accuracy (cal_inpainting.py:173-180), P-IDS = the share of fakes
scored more real than their paired real image (:181-182). The activations
come from the FID Inception of eval/inception.py, as in the JAX package.

The reference and the JAX package fit scikit-learn's
``LinearSVC(dual=False)``: liblinear's primal L2-regularised squared-hinge
SVM, C = 1, with the intercept a feature of constant 1 that is regularised
like the weights (``intercept_scaling=1``). ``fit_linear_svc`` solves the
same problem on the host in float64 with numpy: Newton steps on the
generalised Hessian I + 2C X_A^T X_A of the margin violators A, each with
an exact line search along the piecewise-quadratic objective (the finite
Newton method of Keerthi and DeCoste, 2005), to the optimum, where
liblinear stops at a relative gradient of 1e-4.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from lfm_tpu_torch.data.transforms import require_pil
from lfm_tpu_torch.eval.fid import ActivationExtractor, calculate_frechet_distance


def _list_images(folder: str, limit: Optional[int] = None):
    files = sorted(glob.glob(os.path.join(folder, "*.png"))
                   + glob.glob(os.path.join(folder, "*.jpg")))
    return files[:limit] if limit else files


def _activations(files: Sequence[str], extractor: ActivationExtractor,
                 batch_size: int = 50) -> np.ndarray:
    Image = require_pil("reading the inpainting metrics' images")
    acts = []
    for i in range(0, len(files), batch_size):
        imgs = [np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
                for f in files[i: i + batch_size]]
        acts.append(extractor(np.stack(imgs)))
    return np.concatenate(acts, axis=0)


def _line_minimum(wd: float, dd: float, a: np.ndarray, b: np.ndarray, c: float) -> float:
    """argmin over s >= 0 of 0.5 |w + s d|^2 + c sum_i max(0, a_i - s b_i)^2
    (a_i = 1 - y_i w.x_i, b_i = y_i d.x_i, wd = w.d, dd = d.d). Its
    derivative wd + s dd - 2c sum_i b_i max(0, a_i - s b_i) is continuous,
    increasing and linear between the breakpoints a_i / b_i: walk them from
    s = 0 to the piece that holds its root."""
    nz = b != 0  # a term with b_i = 0 is constant along d
    a, b = a[nz], b[nz]
    knots = np.sort(a / b)
    edges = np.concatenate([[0.0], knots[knots > 0], [np.inf]])
    for s0, s1 in zip(edges[:-1], edges[1:]):
        mid = s0 + 1.0 if np.isinf(s1) else 0.5 * (s0 + s1)
        on = a - mid * b > 0
        g0 = wd - 2 * c * float(np.dot(a[on], b[on]))
        g1 = dd + 2 * c * float(np.dot(b[on], b[on]))
        if -g0 / g1 <= s1:
            return max(-g0 / g1, s0)
    raise AssertionError("unreachable: the last piece holds the root")


def fit_linear_svc(x: np.ndarray, labels: np.ndarray, c: float = 1.0, max_iter: int = 100,
                   tol: float = 1e-12) -> Tuple[np.ndarray, float]:
    """LinearSVC(dual=False, C=c).fit(x, labels) for labels in {0, 1} (1 the
    positive class): returns (w, b) of the decision function x.w + b."""
    xa = np.concatenate([np.asarray(x, np.float64), np.ones((len(x), 1))], axis=1)
    y = np.where(np.asarray(labels) == 1, 1.0, -1.0)
    w = np.zeros(xa.shape[1])
    g0 = None
    for _ in range(max_iter):
        margin = 1.0 - y * (xa @ w)
        act = margin > 0
        xs, ys = xa[act], y[act]
        grad = w - 2 * c * xs.T @ (ys * margin[act])
        gnorm = float(np.linalg.norm(grad))
        g0 = gnorm if g0 is None else g0
        if gnorm <= tol * max(g0, 1.0):
            break
        hess = 2 * c * xs.T @ xs
        hess[np.diag_indices_from(hess)] += 1.0
        d = -np.linalg.solve(hess, grad)
        s = _line_minimum(float(w @ d), float(d @ d), margin, y * (xa @ d), c)
        w = w + s * d
    return w[:-1], float(w[-1])


def pids_uids(fake_acts: np.ndarray, real_acts: np.ndarray) -> Tuple[float, float]:
    """(cal_inpainting.py:173-182): (P-IDS, U-IDS)."""
    inputs = np.concatenate([real_acts, fake_acts])
    targets = np.array([1] * len(real_acts) + [0] * len(fake_acts))
    w, b = fit_linear_svc(inputs, targets)
    uids = 1.0 - float(np.mean((inputs @ w + b > 0).astype(int) == targets))
    real_out = real_acts @ w + b
    fake_out = fake_acts @ w + b
    pids = float(np.mean(fake_out > real_out))
    return pids, uids


def metrics_from_activations(fake_acts: np.ndarray, real_acts: np.ndarray):
    """(fid, pids, uids) of in-memory activations."""
    mu1, sigma1 = fake_acts.mean(0), np.cov(fake_acts, rowvar=False)
    mu2, sigma2 = real_acts.mean(0), np.cov(real_acts, rowvar=False)
    fid = calculate_frechet_distance(mu1, sigma1, mu2, sigma2)
    pids, uids = pids_uids(fake_acts, real_acts)
    return fid, pids, uids


def calculate_metrics(fake_folder: str, real_folder: str, inception_params,
                      batch_size: int = 50, limit: Optional[int] = 2950, device=None):
    """(cal_inpainting.py:126-184): (fid, pids, uids) of two image folders."""
    l_fake = _list_images(fake_folder)
    l_real = _list_images(real_folder, limit=limit)
    if len(l_fake) != len(l_real):
        raise ValueError(f"{len(l_fake)} fake images against {len(l_real)} real ones")
    extractor = ActivationExtractor(inception_params, device)
    return metrics_from_activations(_activations(l_fake, extractor, batch_size),
                                    _activations(l_real, extractor, batch_size))
