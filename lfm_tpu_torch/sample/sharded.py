"""FID sample generation over the ranks (port of lfm_tpu/sample/sharded.py;
the reference's --compute_fid mode, test_flow_latent.py:248-283, and its
torchrun harness, test_flow_latent_ddp.py:22-153).

Per step: the batch's global sample indices, then their noise and labels
from the counter-based ``SampleRNG`` (keyed by index, so the generated set
does not depend on the batch size or the number of ranks), the ODE, the
VAE decode, the clip to [0, 1] and Inception pool3 on the device
(``make_sampler`` and ``eval/fid.ActivationExtractor``). JAX's arithmetic
sets the batch: ``per_dev = max(1, batch_size // n_dev)`` rows a rank,
``global_batch = per_dev * n_dev``, ``ceil(n_sample / global_batch)``
steps. Each rank evaluates its contiguous rows of every step's global
indices (an adaptive solver's step control is shared over the ranks, as
JAX's one controller over the global batch); the 2048-d activations are
all-gathered so that every rank scores the identical set, and the images
too when ``save_dir`` is given, which rank 0 alone writes. The last batch
is padded with the last index and deduplicated, so exactly ``n_sample``
rows are scored against the precomputed statistics (eval/fid.py).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from lfm_tpu_torch.core.config import Config
from lfm_tpu_torch.core.device import DeviceLike, resolve_device
from lfm_tpu_torch.core.multihost import is_main_process
from lfm_tpu_torch.core.rng import SampleRNG
from lfm_tpu_torch.core.sharding import DATA_AXIS, Mesh, make_mesh
from lfm_tpu_torch.eval.fid import ActivationExtractor, fid_from_activations
from lfm_tpu_torch.sample.sample import make_sampler, noise_and_labels


def _gather(x: torch.Tensor, group) -> np.ndarray:
    """This rank's rows -> every rank's rows in rank order, as host numpy on
    every rank (JAX's ``process_allgather``). The gather runs where x lies:
    on the card under NCCL."""
    if group is not None:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts)
    return x.cpu().numpy()


def make_sharded_generator(config: Config, model, params=None, vae=None, vae_params=None,
                           inception_params: Optional[Dict[str, torch.Tensor]] = None,
                           mesh: Optional[Mesh] = None, need_images: bool = True,
                           device: DeviceLike = None):
    """Returns (step_fn, n_steps, global_batch): ``step_fn(step)`` generates
    one global batch and returns host numpy on every rank (images or None,
    activations or None, nfe, indices). ``mesh`` defaults to every rank on
    the data axis; ``inception_params`` is FIDInceptionV3's state dict.
    With ``need_images=False`` only the activations leave the device."""
    mesh = mesh if mesh is not None else make_mesh()
    device = resolve_device(device)
    sc = config.sample
    n_dev = mesh.size
    per_dev = max(1, sc.batch_size // n_dev)
    global_batch = per_dev * n_dev
    n_steps = int(math.ceil(sc.n_sample / global_batch))
    start = mesh.coords[DATA_AXIS] * per_dev
    group = mesh.group(DATA_AXIS)
    if mesh.shape[DATA_AXIS] != n_dev:
        raise ValueError(f"FID generation splits its batch over the data axis only; got "
                         f"{mesh.shape}")
    rng = SampleRNG(seed=sc.seed, num_samples=sc.n_sample)
    sampler = make_sampler(config, model, params, vae, vae_params, device=device, group=group)
    extractor = (None if inception_params is None
                 else ActivationExtractor(inception_params, device=device))

    def step_fn(step: int):
        idx = rng.batch_indices(done=step * global_batch, batch=global_batch)
        noise, y = noise_and_labels(config, rng, idx[start:start + per_dev], device=device)
        out = sampler(noise, y)
        acts = None if extractor is None else extractor(out.images)
        if acts is not None and group is not None:
            acts = _gather(torch.from_numpy(acts).to(out.images.device), group)
        img = _gather(out.images.float(), group) if need_images else None
        return img, acts, float(out.nfe), idx.numpy()

    return step_fn, n_steps, global_batch


def generate_fid_activations(config: Config, model, params, vae, vae_params,
                             inception_params: Dict[str, torch.Tensor],
                             mesh: Optional[Mesh] = None, save_dir: Optional[str] = None,
                             device: DeviceLike = None) -> np.ndarray:
    """Generate n_sample images and return their (n_sample, 2048) pool3
    activations, deduplicated to exactly n_sample rows, on every rank. With
    ``save_dir`` rank 0 writes the images as the reference's
    ``{index}.jpg`` (test_flow_latent.py:267-269), which needs PIL."""
    step_fn, n_steps, _ = make_sharded_generator(
        config, model, params, vae, vae_params, inception_params, mesh,
        need_images=save_dir is not None, device=device)
    n = config.sample.n_sample
    acts = np.zeros((n, 2048), np.float32)
    seen = np.zeros(n, bool)
    save_here = save_dir is not None and is_main_process()
    for step in range(n_steps):
        img, a, _, idx = step_fn(step)
        for row, i in enumerate(idx):
            if not seen[i]:
                acts[i] = a[row]
                seen[i] = True
        if save_here:
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
                mesh: Optional[Mesh] = None, save_dir: Optional[str] = None,
                device: DeviceLike = None) -> float:
    """FID of n_sample generated images against precomputed statistics (the
    reference's --compute_fid mode, test_flow_latent.py:248-283)."""
    acts = generate_fid_activations(config, model, params, vae, vae_params, inception_params,
                                    mesh, save_dir, device=device)
    return fid_from_activations(acts, stats_path)
