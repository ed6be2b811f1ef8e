"""Perceptual metrics for inpainting evaluation: SSIM and LPIPS (port of
lfm_tpu/eval/perceptual.py; reference
datasets_prep/inpaint_preprocess/losses/ssim.py, lpips.py).

* SSIM: the Gaussian-window structural similarity (window 11, sigma 1.5)
  as a depthwise convolution with zero padding, mean per image.
* LPIPS: VGG16 features (after relu1_2, relu2_2, relu3_3, relu4_3 and
  relu5_3), unit-normalised over channels, squared differences weighted by
  the learned linear heads, averaged over pixels and summed over layers.
  ``convert_lpips_state_dict`` takes torchvision's VGG16 ``features.*``
  and lpips' ``lin{i}.model.1.weight``; no weights are shipped.

Inputs are NHWC, as the JAX package's; everything runs in f32 with TF32
off on the card.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from lfm_tpu_torch.core.device import no_tf32

_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512)
# feature taps after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_TAPS = (1, 3, 6, 9, 12)  # indices into the conv list
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11, sigma: float = 1.5,
         data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM per image; img: (N, H, W, C) in [0, data_range]."""
    c = img1.shape[-1]
    w = _gaussian_window(window_size, sigma).to(img1.device)
    kern = w[None, None].expand(c, 1, window_size, window_size)
    pad = window_size // 2

    def filt(x):
        return F.conv2d(x, kern, padding=pad, groups=c)

    a, b = (t.float().permute(0, 3, 1, 2) for t in (img1, img2))
    with no_tf32():
        mu1, mu2 = filt(a), filt(b)
        mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        s1 = filt(a * a) - mu1_sq
        s2 = filt(b * b) - mu2_sq
        s12 = filt(a * b) - mu12
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return m.mean(dim=(1, 2, 3))


class VGG16Features(nn.Module):
    """torchvision's ``vgg16().features`` layout (conv, relu, ..., max-pool),
    returning the five tapped relu outputs, NCHW."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        ch = 3
        for v in _VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(ch, v, 3, padding=1), nn.ReLU()]
                ch = v
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats, conv_i = [], 0
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                if conv_i in _TAPS:
                    feats.append(x)
                conv_i += 1
        return feats


class LPIPS(nn.Module):
    """Perceptual distance of (N, H, W, 3) images in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        chans = [v for i, v in enumerate(c for c in _VGG16_CFG if c != "M") if i in _TAPS]
        self.lins = nn.ModuleList(nn.Linear(ch, 1, bias=False) for ch in chans)
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        total = 0.0
        with no_tf32():
            fx, fy = (self.vgg((t.float().permute(0, 3, 1, 2) - self.shift) / self.scale)
                      for t in (x, y))
            for lin, a, b in zip(self.lins, fx, fy):
                a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
                b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
                diff = ((a - b) ** 2).permute(0, 2, 3, 1)
                total = total + lin(diff).mean(dim=(1, 2, 3))
        return total


def convert_lpips_state_dict(vgg_sd: Mapping, lin_sd: Mapping) -> Dict[str, torch.Tensor]:
    """torchvision vgg16 ``features.*`` and lpips ``lin{i}.model.1.weight``
    (1, C, 1, 1) -> ``LPIPS``'s state dict."""
    sd = {f"vgg.{k}": torch.as_tensor(v).float() for k, v in vgg_sd.items()
          if k.startswith("features.")}
    for i in range(len(_TAPS)):
        sd[f"lins.{i}.weight"] = torch.as_tensor(lin_sd[f"lin{i}.model.1.weight"]).float()[
            :, :, 0, 0]
    return sd
