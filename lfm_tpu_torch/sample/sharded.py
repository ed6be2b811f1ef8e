"""FID sample generation on one device (port of lfm_tpu/sample/sharded.py;
the reference's --compute_fid mode, test_flow_latent.py:248-283).

Per step: the batch's global sample indices, then their noise and labels
from the counter-based ``SampleRNG`` (keyed by index, so the generated set
does not depend on the batch size), the ODE, the VAE decode, the clip to
[0, 1] and Inception pool3 on the device (``make_sampler`` and
``eval/fid.ActivationExtractor``). Only the 2048-d activations reach the
host, and the images too when ``save_dir`` is given. The last batch is
padded with the last index and deduplicated, so exactly ``n_sample`` rows
are scored against the precomputed statistics (eval/fid.py).

The JAX package shards each batch over a device mesh; here a mesh larger
than one device raises (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from lfm_tpu_torch.core.config import Config
from lfm_tpu_torch.core.device import DeviceLike, resolve_device
from lfm_tpu_torch.core.rng import SampleRNG
from lfm_tpu_torch.eval.fid import ActivationExtractor, fid_from_activations
from lfm_tpu_torch.sample.sample import make_sampler, noise_and_labels


def make_sharded_generator(config: Config, model, params=None, vae=None, vae_params=None,
                           inception_params: Optional[Dict[str, torch.Tensor]] = None,
                           mesh: Optional[int] = None, need_images: bool = True,
                           device: DeviceLike = None):
    """Returns (step_fn, n_steps, global_batch): ``step_fn(step)`` generates
    one batch and returns host numpy (images or None, activations or None,
    nfe, indices). ``mesh`` is the number of devices, and only 1 is
    ported; ``inception_params`` is FIDInceptionV3's state dict. With
    ``need_images=False`` only the activations leave the device."""
    if mesh not in (None, 1):
        raise NotImplementedError(f"FID generation over {mesh} devices is not ported yet "
                                  "(ROADMAP Queue 1 item 8)")
    device = resolve_device(device)
    sc = config.sample
    global_batch = sc.batch_size
    n_steps = int(math.ceil(sc.n_sample / global_batch))
    rng = SampleRNG(seed=sc.seed, num_samples=sc.n_sample)
    sampler = make_sampler(config, model, params, vae, vae_params, device=device)
    extractor = (None if inception_params is None
                 else ActivationExtractor(inception_params, device=device))

    def step_fn(step: int):
        idx = rng.batch_indices(done=step * global_batch, batch=global_batch)
        noise, y = noise_and_labels(config, rng, idx, device=device)
        out = sampler(noise, y)
        acts = None if extractor is None else extractor(out.images)
        img = out.images.float().cpu().numpy() if need_images else None
        return img, acts, float(out.nfe), idx.numpy()

    return step_fn, n_steps, global_batch


def generate_fid_activations(config: Config, model, params, vae, vae_params,
                             inception_params: Dict[str, torch.Tensor], mesh: Optional[int] = None,
                             save_dir: Optional[str] = None,
                             device: DeviceLike = None) -> np.ndarray:
    """Generate n_sample images and return their (n_sample, 2048) pool3
    activations, deduplicated to exactly n_sample rows. With ``save_dir``
    the images are written as the reference's ``{index}.jpg``
    (test_flow_latent.py:267-269), which needs PIL."""
    step_fn, n_steps, _ = make_sharded_generator(
        config, model, params, vae, vae_params, inception_params, mesh,
        need_images=save_dir is not None, device=device)
    n = config.sample.n_sample
    acts = np.zeros((n, 2048), np.float32)
    seen = np.zeros(n, bool)
    for step in range(n_steps):
        img, a, _, idx = step_fn(step)
        for row, i in enumerate(idx):
            if not seen[i]:
                acts[i] = a[row]
                seen[i] = True
        if save_dir is not None:
            from PIL import Image

            os.makedirs(save_dir, exist_ok=True)
            for row, i in enumerate(idx):
                arr = (img[row] * 255).astype(np.uint8)
                Image.fromarray(arr).save(os.path.join(save_dir, f"{int(i)}.jpg"))
    if not seen.all():
        raise RuntimeError(f"{int((~seen).sum())} of {n} samples were never generated")
    return acts


def compute_fid(config: Config, model, params, vae, vae_params,
                inception_params: Dict[str, torch.Tensor], stats_path: str,
                mesh: Optional[int] = None, save_dir: Optional[str] = None,
                device: DeviceLike = None) -> float:
    """FID of n_sample generated images against precomputed statistics (the
    reference's --compute_fid mode, test_flow_latent.py:248-283)."""
    acts = generate_fid_activations(config, model, params, vae, vae_params, inception_params,
                                    mesh, save_dir, device=device)
    return fid_from_activations(acts, stats_path)
