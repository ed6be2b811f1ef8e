"""Sampling and evaluation of the downstream tasks on one device (port of
lfm_tpu/sample/downstream.py; reference
downstream_tasks/test_flow_latent_inpainting.py:20-170 and
test_flow_latent_semantic_syn.py).

* Inpainting: the fixed CelebA-HQ evaluation set (image and mask pairs);
  c = VAE(masked) ++ the mask at latent resolution, the conditional ODE,
  the decode and the composite ``fake * mask + (1 - mask) * real``
  (test:160-161), so that outside the hole the output is the input image
  exactly; ``run_inpainting_eval`` writes ``{i}.jpg`` for FID / P-IDS /
  U-IDS scoring (eval/inpainting_metrics.py).
* Semantic synthesis: one-hot labels -> SpatialRescaler -> the
  conditional ODE -> decode; ``to_rgb`` projects a one-hot map to RGB for
  plots (train_flow_latent_semantic_syn.py:36-41).

The noise, and the VAE posterior draw of the masked image, come from the
per-sample generators of core/rng.py keyed by the sample's index, so any
batching draws the same; JAX's threefry bits cannot be matched.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from lfm_tpu_torch.core.config import Config
from lfm_tpu_torch.core.device import DeviceLike, resolve_device
from lfm_tpu_torch.core.rng import SampleRNG
from lfm_tpu_torch.data.transforms import require_pil
from lfm_tpu_torch.ode.solvers import ADAPTIVE_SOLVERS
from lfm_tpu_torch.sample.sample import SampleOutput
from lfm_tpu_torch.train.conditional import mask_to_latent, sample_conditional

ENCODE_STREAM = 0x1E  # the posterior eps's stream beside the noise's


class InpaintingEvalDataset:
    """(test_flow_latent_inpainting.py:24-54): images ``{i:06d}.jpg`` and
    masks ``{i:06d}.png`` (255 = keep in the file; inverted here so that 1
    = hole). Yields (img, mask, masked): img and masked in [-1, 1], the mask
    (H, W, 1) in {0, 1}."""

    def __init__(self, indir: str, maskdir: str, n: Optional[int] = None):
        self.indir = indir
        self.maskdir = maskdir
        if n is None:
            # the reference pins 2,993 (test:32); at most what is on disk
            avail = len([f for f in os.listdir(indir) if f.endswith(".jpg")])
            n = min(2993, avail)
        self.n = n
        self.num_classes = 1

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        Image = require_pil("InpaintingEvalDataset")
        img = np.asarray(Image.open(os.path.join(self.indir, f"{i:06d}.jpg")).convert("RGB"),
                         np.float32) / 255.0
        mask = np.asarray(Image.open(os.path.join(self.maskdir, f"{i:06d}.png")),
                          np.float32) / 255.0
        mask = 1.0 - mask  # 1 = hole
        if mask.ndim == 3:
            mask = mask[..., 0]
        masked = (1.0 - mask[..., None]) * img
        return (img * 2 - 1, mask[..., None].astype(np.float32), masked * 2 - 1)


def _prepare(module, params, device: torch.device):
    if params is not None:
        module.load_state_dict(params)
    return module.to(device).eval()


def make_inpainting_sampler(config: Config, model, params, vae, vae_params, *, seed: int = 42,
                            device: DeviceLike = None) -> Callable:
    """Returns ``fn(image, mask, masked, indices) -> SampleOutput`` whose
    images are the composites in [0, 1]; ``indices`` are the samples'
    global indices (their noise and posterior eps, from ``seed``).
    ``params`` and ``vae_params``, where given, are state dicts loaded into
    ``model`` and ``vae``."""
    device = resolve_device(device)
    sc, scale = config.sample, config.scale_factor
    model, vae = _prepare(model, params, device), _prepare(vae, vae_params, device)
    rng = SampleRNG(seed)
    atol = sc.atol if sc.method in ADAPTIVE_SOLVERS else 1e-8

    @torch.no_grad()
    def fn(image, mask, masked, indices) -> SampleOutput:
        image, mask, masked = (torch.as_tensor(a).to(device, torch.float32)
                               for a in (image, mask, masked))
        mean, logvar = vae.encode_moments(masked)
        eps = rng.randn(indices, mean.shape[1:], device=device, stream=ENCODE_STREAM)
        cz = (mean + torch.exp(0.5 * logvar) * eps) * scale
        c = torch.cat([cz, mask_to_latent(mask, cz.shape[1:3])], dim=-1)
        noise = rng.randn(indices, cz.shape[1:3] + (4,), device=device)
        z0, nfe = sample_conditional(model, c, noise, method=sc.method, atol=atol,
                                     rtol=sc.rtol, num_steps=sc.num_steps)
        fake01 = torch.clamp((vae.decode(z0 / scale) + 1) / 2, 0, 1)
        img01 = (image + 1) / 2
        # generated content inside the hole, the real image outside it
        return SampleOutput(images=fake01 * mask + (1 - mask) * img01, latents=z0, nfe=nfe)

    return fn


def run_inpainting_eval(config: Config, model, params, vae, vae_params, dataset,
                        save_dir: str, batch_size: int = 25, seed: int = 42,
                        log_fn: Callable = print, device: DeviceLike = None) -> None:
    """Composited inpaintings of the whole evaluation set as ``{i}.jpg``
    (test_flow_latent_inpainting.py:143-168); score them with
    eval/inpainting_metrics.py::calculate_metrics."""
    Image = require_pil("run_inpainting_eval's JPEG files")
    os.makedirs(save_dir, exist_ok=True)
    sampler = make_inpainting_sampler(config, model, params, vae, vae_params, seed=seed,
                                      device=device)
    n = len(dataset)
    for start in range(0, n, batch_size):
        idx = range(start, min(start + batch_size, n))
        items = [dataset[i] for i in idx]
        out = sampler(*(np.stack([it[k] for it in items]) for k in range(3)), idx)
        out = out.images.cpu().numpy()
        for j, i in enumerate(idx):
            Image.fromarray((out[j] * 255).astype(np.uint8)).save(
                os.path.join(save_dir, f"{i}.jpg"))
        log_fn(f"generating batch {start // batch_size}")


def make_semantic_sampler(config: Config, model, params, rescaler, rescaler_params, vae,
                          vae_params, num_classes: int, *, seed: int = 0,
                          device: DeviceLike = None) -> Callable:
    """Returns ``fn(seg, indices) -> SampleOutput`` with images in [0, 1];
    the solver at atol = rtol = 1e-8 as JAX's."""
    device = resolve_device(device)
    sc, scale = config.sample, config.scale_factor
    model, vae = _prepare(model, params, device), _prepare(vae, vae_params, device)
    rescaler = _prepare(rescaler, rescaler_params, device)
    rng = SampleRNG(seed)

    @torch.no_grad()
    def fn(seg, indices) -> SampleOutput:
        seg = torch.as_tensor(seg).to(device, torch.long)
        c = rescaler(F.one_hot(seg, num_classes).float())
        noise = rng.randn(indices, c.shape[1:3] + (4,), device=device)
        z0, nfe = sample_conditional(model, c, noise, method=sc.method, atol=1e-8, rtol=1e-8,
                                     num_steps=sc.num_steps)
        img = torch.clamp((vae.decode(z0 / scale) + 1) / 2, 0, 1)
        return SampleOutput(images=img, latents=z0, nfe=nfe)

    return fn


def to_rgb(onehot_seg: torch.Tensor, weight: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A random 1x1 projection of a one-hot map (..., K) to RGB in [-1, 1]
    for plots (train_flow_latent_semantic_syn.py:36-41): ``weight`` (K, 3),
    else N(0, 1) drawn from ``generator``."""
    if weight is None:
        weight = torch.randn((onehot_seg.shape[-1], 3), generator=generator,
                             device=onehot_seg.device)
    x = onehot_seg.float() @ weight.float()
    return 2.0 * (x - x.min()) / (x.max() - x.min()) - 1.0
