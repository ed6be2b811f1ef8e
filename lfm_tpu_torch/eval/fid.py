"""FID: pool3 statistics and the Fréchet distance (port of lfm_tpu/eval/fid.py).

Mirrors the reference scoring path (reference pytorch_fid/fid_score.py):
activations batched through InceptionV3 on the device, mu and sigma on the
host, ``scipy.linalg.sqrtm`` Fréchet distance with the same eps fallback
(fid_score.py:177-227), and the same stats-file formats: a ``.npy`` holding
a pickled {"mu", "sigma"} dict, or an ``.npz`` with those keys
(fid_score.py:254-265), so the reference's precomputed dataset statistics
load unchanged.
"""

from __future__ import annotations

import os
import pathlib
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from lfm_tpu_torch.core.device import DeviceLike, no_tf32, resolve_device

IMAGE_EXTENSIONS = {"bmp", "jpg", "jpeg", "pgm", "png", "ppm", "tif", "tiff", "webp"}


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Stable Fréchet distance (fid_score.py:177-227)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape and sigma1.shape == sigma2.shape

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


class ActivationExtractor:
    """pool3 features of [0, 1] NHWC image batches on ``device`` (the card
    unless ``device="cpu"``), f32 throughout: the convolutions run with TF32
    off (``no_tf32``), so that f32 is f32 on the card."""

    def __init__(self, params: Dict[str, torch.Tensor], device: DeviceLike = None):
        from lfm_tpu_torch.eval.inception import FIDInceptionV3

        self.device = resolve_device(device)
        self._model = FIDInceptionV3()
        self._model.load_state_dict(params)
        self._model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, images) -> np.ndarray:
        x = torch.as_tensor(images).to(self.device, torch.float32)
        with no_tf32():
            return self._model(x).cpu().numpy()

    def over_batches(self, batches: Iterable) -> np.ndarray:
        return np.concatenate([self(b) for b in batches], axis=0)


def activation_statistics(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = np.mean(acts, axis=0)
    sigma = np.cov(acts, rowvar=False)
    return mu, sigma


def load_statistics(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read the reference's stats format (fid_score.py:254-261)."""
    f = np.load(path, allow_pickle=True)
    try:
        return f["mu"][:], f["sigma"][:]
    except IndexError:
        d = f.item()
        return d["mu"][:], d["sigma"][:]


def save_statistics(path: str, mu: np.ndarray, sigma: np.ndarray) -> None:
    """Write stats in the reference's .npy dict format
    (pytorch_fid/compute_dataset_stat.py:50-57)."""
    np.save(path, {"mu": mu, "sigma": sigma})


def _iter_image_files(path: str):
    p = pathlib.Path(path)
    return sorted(f for ext in IMAGE_EXTENSIONS for f in p.glob(f"*.{ext}"))


def statistics_of_path(path: str, extractor: ActivationExtractor,
                       batch_size: int = 50) -> Tuple[np.ndarray, np.ndarray]:
    if path.endswith((".npz", ".npy")):
        return load_statistics(path)
    from PIL import Image

    files = _iter_image_files(path)
    if not files:
        raise RuntimeError(f"no images found in {path}")
    acts = []
    for i in range(0, len(files), batch_size):
        imgs = [np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
                for f in files[i: i + batch_size]]
        acts.append(extractor(np.stack(imgs)))
    return activation_statistics(np.concatenate(acts, axis=0))


def calculate_fid_given_paths(paths: Sequence[str], inception_params: Dict[str, torch.Tensor],
                              batch_size: int = 50, device: DeviceLike = None) -> float:
    """Drop-in equivalent of fid_score.py:268-283 (paths may be image dirs or
    precomputed-stats files)."""
    for p in paths:
        if not os.path.exists(p):
            raise RuntimeError(f"Invalid path: {p}")
    extractor = ActivationExtractor(inception_params, device)
    m1, s1 = statistics_of_path(paths[0], extractor, batch_size)
    m2, s2 = statistics_of_path(paths[1], extractor, batch_size)
    return calculate_frechet_distance(m1, s1, m2, s2)


def fid_from_activations(acts: np.ndarray, stats_path: str) -> float:
    """FID of in-memory generated-sample activations against precomputed
    stats (no JPEG round-trip)."""
    mu1, sigma1 = activation_statistics(acts)
    mu2, sigma2 = load_statistics(stats_path)
    return calculate_frechet_distance(mu1, sigma1, mu2, sigma2)
