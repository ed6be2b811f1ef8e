"""Inception Score (port of lfm_tpu/eval/inception_score.py; reference
pytorch_fid/inception_score.py).

IS = exp(E_x KL(p(y|x) || p(y))) over the class posteriors. The reference
uses a TF-hub classifier (inception_score.py:42-63); here, as in the JAX
package, the logits are the 1008-way head of the FID Inception
(eval/inception.py, ``include_head=True``), so no other weights are needed.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from lfm_tpu_torch.core.device import DeviceLike, no_tf32, resolve_device


def inception_score_from_probs(probs: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """probs: (N, K) softmax class posteriors -> (mean, std) over splits."""
    scores = []
    n = len(probs)
    for i in range(splits):
        part = probs[i * n // splits: (i + 1) * n // splits]
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(py + 1e-16))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


@torch.no_grad()
def get_inception_score(images: Iterable[np.ndarray], inception_params, splits: int = 10,
                        device: DeviceLike = None) -> Tuple[float, float]:
    """images: an iterable of (B, H, W, 3) batches in [0, 1]."""
    from lfm_tpu_torch.eval.inception import FIDInceptionV3

    device = resolve_device(device)
    model = FIDInceptionV3(include_head=True)
    model.load_state_dict(inception_params)
    model.to(device).eval()
    probs = []
    with no_tf32():
        for batch in images:
            x = torch.as_tensor(batch).to(device, torch.float32)
            probs.append(torch.softmax(model(x), dim=-1).cpu().numpy())
    return inception_score_from_probs(np.concatenate(probs, axis=0), splits)
