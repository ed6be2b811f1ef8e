"""lfm_tpu_torch: the PyTorch / CUDA port of lfm_tpu for one NVIDIA H100.

The JAX package ``lfm_tpu`` stays the reference; this package keeps its
layout and names and imports neither ``jax`` nor anything of ``lfm_tpu``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
