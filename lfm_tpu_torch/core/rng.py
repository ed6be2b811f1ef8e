"""Deterministic, world-size-invariant sampling RNG (port of lfm_tpu/core/rng.py).

Sample ``i`` always draws from its own ``torch.Generator`` seeded from
(seed, i), so any split of the sample-index space into batches or ranks
draws identical noise. The draws are made on the CPU and then moved to the
device, so they are the same on every device. They cannot reproduce JAX's
threefry bits: parity tests hand the same numpy noise to both packages.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from lfm_tpu_torch.core.device import DeviceLike, resolve_device

_MASK64 = (1 << 64) - 1
_LABEL_STREAM = 0x7FFF  # distinct stream tag so class draws never alias noise


def _mix(*words: int) -> int:
    """splitmix64 over the words: a 63-bit seed for ``manual_seed``."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (int(w) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


def seeded_generator(device: torch.device, *words: int,
                     rows: Optional[Tuple[int, int, int]] = None) -> torch.Generator:
    """A generator on ``device`` seeded from the words (such as a seed and
    a step number). With ``rows`` = (start, stop, total) it is a
    ``RowGenerator`` for rows [start, stop) of a batch of ``total``."""
    g = torch.Generator(device=device) if rows is None else RowGenerator(device, *rows)
    g.manual_seed(_mix(*words))
    return g


class RowGenerator(torch.Generator):
    """A train step's generator on one rank of a data-parallel batch: the
    draws through ``draw_rows`` are made at the global
    batch's size, in the same order on every rank, and the rank keeps its
    rows [start, stop). So each rank sees exactly the numbers that one
    process drawing for the whole batch gives those rows, as JAX draws one
    key over the global batch (lfm_tpu/train/train.py:53-65)."""

    def __new__(cls, device, start: int, stop: int, total: int):
        return super().__new__(cls, device=device)

    def __init__(self, device, start: int, stop: int, total: int):
        if not 0 <= start < stop <= total:
            raise ValueError(f"rows [{start}, {stop}) of {total}")
        self.start, self.stop, self.total = start, stop, total


def draw_rows(draw, shape: Sequence[int], generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """``draw(shape, generator=, device=)`` (``torch.rand`` or
    ``torch.randn``); from a ``RowGenerator`` the draw is made for the
    global batch and the rank keeps its rows, so ``shape[0]`` must be the
    rank's rows."""
    shape = tuple(shape)
    if not isinstance(generator, RowGenerator):
        return draw(shape, generator=generator, device=device)
    if shape[0] != generator.stop - generator.start:
        raise ValueError(f"a draw of {shape} on rows [{generator.start}, {generator.stop}): "
                         "its leading dimension must be the rank's rows")
    full = draw((generator.total,) + shape[1:], generator=generator, device=device)
    return full[generator.start:generator.stop]


class SampleRNG:
    """Counter-based generator keyed by global sample index
    (reference sampler/random_util.py:36-97, DeterministicGenerator)."""

    def __init__(self, seed: int = 0, num_samples: int = 0):
        self.seed = int(seed)
        self.num_samples = int(num_samples)

    def randn(self, indices, sample_shape: Sequence[int], dtype=torch.float32,
              device: DeviceLike = None, stream: Optional[int] = None) -> torch.Tensor:
        """N(0, 1) of shape ``(len(indices), *sample_shape)``; ``stream``
        tags a second draw of the same samples, independent of the noise
        (the downstream samplers' VAE posterior eps)."""
        device = resolve_device(device)
        tag = () if stream is None else (stream,)
        rows = [torch.randn(tuple(sample_shape), dtype=torch.float32,
                            generator=seeded_generator("cpu", self.seed, i, *tag))
                for i in _as_list(indices)]
        return torch.stack(rows).to(device=device, dtype=dtype)

    def randint(self, indices, low: int, high: int,
                device: DeviceLike = None) -> torch.Tensor:
        """Per-sample class labels (reference test_flow_latent.py:167)."""
        device = resolve_device(device)
        vals = [int(torch.randint(low, high, (), generator=seeded_generator(
            "cpu", self.seed, i, _LABEL_STREAM))) for i in _as_list(indices)]
        return torch.tensor(vals, dtype=torch.int64, device=device)

    def batch_indices(self, done: int, batch: int, rank: int = 0,
                      world_size: int = 1) -> torch.Tensor:
        """Rank-strided global indices for the next batch
        (reference sampler/random_util.py:58-67)."""
        idx = done + rank + world_size * torch.arange(batch, dtype=torch.int64)
        if self.num_samples:
            idx = idx.clamp(0, self.num_samples - 1)
        return idx


def _as_list(indices) -> list:
    if isinstance(indices, torch.Tensor):
        return [int(i) for i in indices.reshape(-1).tolist()]
    return [int(i) for i in indices]
