"""Pre-encode a dataset into VAE latents with the port's VAE (the port of
tools/prepare_latent_dataset.py; the reference's 'latent_*' fast path,
train_flow_latent.py:132,140-141: training then skips the frozen VAE encode
each step).

    python -m lfm_tpu_torch.tools.prepare_latent_dataset --dataset imagenet_256 \\
        --datadir ... --vae_ckpt diffusion_pytorch_model.bin --out data/latent_imagenet_256

Reads the dataset through ``get_dataset`` in order (no shuffle, the last
batch ragged), encodes each batch with the bf16 VAE (a draw of its
diagonal Gaussian, batch i's noise from the seed and i), and writes
``latents.npy`` (N, h, w, 4) float16, UNSCALED (``scale_factor`` is applied
at train time), and ``labels.npy``, the files ``LatentDataset`` reads. Runs
on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from lfm_tpu_torch.core.config import Config, DataConfig, ModelConfig
from lfm_tpu_torch.core.device import DeviceLike, resolve_device
from lfm_tpu_torch.core.rng import seeded_generator
from lfm_tpu_torch.data import DataLoader, get_dataset


def write_latents(dataset, vae, out: str, *, batch_size: int = 32, seed: int = 0) -> int:
    """Encode ``dataset`` with ``vae`` (this package's AutoencoderKL, on its
    device) into ``out``/latents.npy and labels.npy; returns the count."""
    device = next(vae.parameters()).device
    loader = DataLoader(dataset, batch_size, shuffle=False, drop_last=False)
    zs, ys = [], []
    with torch.no_grad():
        for i, batch in enumerate(loader):
            x = torch.from_numpy(batch["x"]).to(device)
            z = vae.encode_sample(x, seeded_generator(device, seed, i))
            zs.append(z.float().cpu().numpy().astype(np.float16))
            ys.append(np.asarray(batch["y"], np.int32))
    os.makedirs(out, exist_ok=True)
    np.save(os.path.join(out, "latents.npy"), np.concatenate(zs))
    np.save(os.path.join(out, "labels.npy"), np.concatenate(ys))
    return sum(len(z) for z in zs)


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> int:
    p = argparse.ArgumentParser(prog="prepare_latent_dataset")
    p.add_argument("--dataset", required=True)
    p.add_argument("--datadir", required=True)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--vae_ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the card; cpu for the CPU")
    args = p.parse_args(argv)

    from lfm_tpu_torch.vae.autoencoder_kl import create_vae
    from lfm_tpu_torch.vae.convert import load_vae_state_dict

    config = Config(dataset=args.dataset,
                    model=ModelConfig(model_type="DiT-L/2", image_size=args.image_size),
                    data=DataConfig(dataset=args.dataset, datadir=args.datadir))
    vae = create_vae(dtype=torch.bfloat16, device=resolve_device(args.device or device))
    vae.load_state_dict(load_vae_state_dict(args.vae_ckpt))
    vae.eval().requires_grad_(False)
    n = write_latents(get_dataset(config), vae, args.out, batch_size=args.batch_size,
                      seed=args.seed)
    print(f"wrote {n} latents to {args.out}")
    return n


if __name__ == "__main__":
    main()
