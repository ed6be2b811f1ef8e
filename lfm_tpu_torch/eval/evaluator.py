"""Inpainting evaluator (port of lfm_tpu/eval/evaluator.py; reference
datasets_prep/inpaint_preprocess/evaluator.py:16-238).

Scores (real, fake, mask) batches with SSIM, LPIPS (where its weights are
given) and FID / P-IDS / U-IDS over Inception activations (where its
weights are given); like the reference's ``InpaintingEvaluator``, SSIM is
also grouped into bins by the hole's share of the image ("10-20%", ...).
The networks run on ``device`` (the card unless ``device="cpu"``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lfm_tpu_torch.core.device import DeviceLike, resolve_device
from lfm_tpu_torch.eval.perceptual import LPIPS, ssim


class InpaintingEvaluator:
    def __init__(self, inception_params=None, lpips_params=None, area_bins: int = 10,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.area_bins = area_bins
        self._lpips = None
        if lpips_params is not None:
            self._lpips = LPIPS()
            self._lpips.load_state_dict(lpips_params)
            self._lpips.to(self.device).eval()
        self._extractor = None
        if inception_params is not None:
            from lfm_tpu_torch.eval.fid import ActivationExtractor

            self._extractor = ActivationExtractor(inception_params, self.device)
        self._rows: list = []
        self._fake_acts: list = []
        self._real_acts: list = []

    @torch.no_grad()
    def process_batch(self, real01: np.ndarray, fake01: np.ndarray, mask: np.ndarray) -> None:
        """real, fake: (N, H, W, 3) in [0, 1]; mask: (N, H, W, 1), 1 = hole."""
        real, fake = (torch.as_tensor(a).to(self.device, torch.float32) for a in (real01, fake01))
        s = ssim(fake, real).cpu().numpy()
        area = np.asarray(mask).mean(axis=(1, 2, 3))
        lp = None if self._lpips is None else self._lpips(fake * 2 - 1, real * 2 - 1).cpu().numpy()
        for i in range(len(s)):
            self._rows.append({"ssim": float(s[i]),
                               "lpips": None if lp is None else float(lp[i]),
                               "area": float(area[i])})
        if self._extractor is not None:
            self._fake_acts.append(self._extractor(fake01))
            self._real_acts.append(self._extractor(real01))

    def evaluation_end(self) -> Dict:
        """The means over every image, and SSIM's per hole-area bin."""
        out: Dict = {}
        rows = self._rows
        out["ssim"] = float(np.mean([r["ssim"] for r in rows])) if rows else None
        if rows and rows[0]["lpips"] is not None:
            out["lpips"] = float(np.mean([r["lpips"] for r in rows]))
        if self._fake_acts:
            from lfm_tpu_torch.eval.inpainting_metrics import metrics_from_activations

            fid, pids, uids = metrics_from_activations(np.concatenate(self._fake_acts),
                                                       np.concatenate(self._real_acts))
            out.update(fid=fid, pids=pids, uids=uids)
        bins: Dict[str, list] = {}
        for r in rows:
            b = min(int(r["area"] * self.area_bins), self.area_bins - 1)
            lo, hi = b * 100 // self.area_bins, (b + 1) * 100 // self.area_bins
            bins.setdefault(f"{lo}-{hi}%", []).append(r["ssim"])
        out["ssim_by_area"] = {k: float(np.mean(v)) for k, v in sorted(bins.items())}
        return out
