"""FID InceptionV3 (pool3 features) in PyTorch (port of lfm_tpu/eval/inception.py).

The pytorch-fid network the reference evaluates with (reference
pytorch_fid/inception.py:23,70-77): the TF inception-2015-12-05 graph with
pytorch-fid's modifications. InceptionA/C/E(7b) pool branches average with
``count_include_pad=False``, and the second InceptionE (Mixed_7c) max-pools.
Module and tensor names are pytorch-fid's (torchvision's Inception3 with
``aux_logits=False``), so the published
``pt_inception-2015-12-05-6726825d.pth`` loads with ``load_state_dict``
(``load_inception_params``); nothing is downloaded.

Input contract as the JAX module's: images in [0, 1], NHWC; a bilinear
resize to 299 (half-pixel centers, no antialias), then scaled to [-1, 1].
Output: (N, 2048) pool3 activations, or the 1008 fc logits with
``include_head``. The convolutions run NCHW through cuDNN (the JAX module
leaves them to XLA, so no kernel of the port serves them); BatchNorm runs in
inference form with the checkpoint's running statistics, unfolded, in JAX's
order, ``(x - mean) / sqrt(var + 1e-3) * weight + bias``.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Pad = Union[int, Tuple[int, int]]


class _BatchNormInference(nn.BatchNorm2d):
    """BatchNorm2d's parameters and buffers (so pytorch-fid's names and
    ``num_batches_tracked`` load as they are), applied in inference form in
    the JAX module's order (inception.py:50)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        return ((x - self.running_mean.view(shape)) / torch.sqrt(self.running_var.view(shape)
                                                                 + self.eps)
                * self.weight.view(shape) + self.bias.view(shape))


class BasicConv(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3, inference) + relu."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Union[int, Tuple[int, int]] = 3,
                 stride: int = 1, padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        self.bn = _BatchNormInference(out_ch, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _max_pool(x: torch.Tensor, k: int = 3, s: int = 2, p: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, k, s, p)


def _avg_pool_no_pad_count(x: torch.Tensor, k: int = 3, s: int = 1, p: int = 1) -> torch.Tensor:
    """Average pooling with count_include_pad=False (the FID modification,
    pytorch_fid/inception.py FIDInceptionA/C/E)."""
    return F.avg_pool2d(x, k, s, p, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(in_ch, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_no_pad_count(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                      self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool_no_pad_count(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, _max_pool(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    """Mixed_7b: avg pool (count_include_pad=False); Mixed_7c: max pool."""

    def __init__(self, in_ch: int, pool_kind: str = "avg"):
        super().__init__()
        self.pool_kind = pool_kind
        self.branch1x1 = BasicConv(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        pooled = _avg_pool_no_pad_count(x) if self.pool_kind == "avg" else _max_pool(x, 3, 1, 1)
        return torch.cat([b1, b3, bd, self.branch_pool(pooled)], dim=1)


class FIDInceptionV3(nn.Module):
    """pool3-feature extractor. Input (N, H, W, 3) in [0, 1].
    ``include_head`` adds the 1008-way fc logits (for Inception Score)."""

    def __init__(self, resize_input: bool = True, normalize_input: bool = True,
                 include_head: bool = False):
        super().__init__()
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.include_head = include_head
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, 1008)  # kept for the checkpoint; used with include_head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)  # NHWC -> NCHW
        if self.resize_input and (x.shape[2] != 299 or x.shape[3] != 299):
            x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                              antialias=False)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool(x, 3, 2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        x = x.mean(dim=(2, 3))  # adaptive avg pool -> (N, 2048)
        if self.include_head:
            x = self.fc(x)
        return x.float()


def load_inception_params(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a pytorch-fid checkpoint
    (``pt_inception-2015-12-05-6726825d.pth``), for
    ``FIDInceptionV3().load_state_dict``; tensors only."""
    return torch.load(path, map_location="cpu", weights_only=True)


def seeded_inception_state_dict(seed: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights in pytorch-fid's names (num_batches_tracked
    included, as the published checkpoint has them), until that checkpoint
    is in the repository: conv weights N(0, 2 / fan_in), BatchNorm scales
    and running variances in [0.5, 1.5], offsets and running means in
    [-0.2, 0.2], fc N(0, 1 / 2048) with biases in [-0.1, 0.1], as
    tests/test_inception_parity.py draws them. Activations stay of order
    one through the 95 layers, so distances computed with them exercise the
    protocol; they say nothing of image quality."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, ref in FIDInceptionV3().state_dict().items():
        shape = tuple(ref.shape)
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros((), dtype=torch.int64)
            continue
        if key.endswith("conv.weight"):
            v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif key == "fc.weight":
            v = rng.standard_normal(shape) * np.sqrt(1.0 / shape[1])
        elif key == "fc.bias":
            v = rng.uniform(-0.1, 0.1, shape)
        else:
            lo, hi = (0.5, 1.5) if key.endswith(("bn.weight", "bn.running_var")) else (-0.2, 0.2)
            v = rng.uniform(lo, hi, shape)
        sd[key] = torch.from_numpy(v.astype(np.float32))
    return sd
