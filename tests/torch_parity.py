"""Shared pieces of the port's parity tests (tests/test_torch_*.py).

``leaves_process_as_found`` is a module-scoped autouse fixture: each port
test file imports it, so that the file runs with one torch thread and
leaves the process as it found it. With pytest-xdist a worker runs several
files in one process, and whatever a file leaves behind reaches the JAX
files after it. Weights and inputs come from numpy seeds, every tensor
non-zero (adaLN-Zero's zero init would make every block an identity).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX; tests/test_torch_cuda.py runs there
    import jax
except ImportError:
    jax = None


def _state():
    state = {} if jax is None else {
        "jax_enable_x64": bool(jax.config.jax_enable_x64),
        "jax_default_matmul_precision": jax.config.jax_default_matmul_precision,
    }
    return {
        **state,
        "torch_default_dtype": torch.get_default_dtype(),
        "torch_deterministic": torch.are_deterministic_algorithms_enabled(),
        "timm_modules": sorted(k for k in sys.modules if k == "timm" or k.startswith("timm.")),
        # pytest itself rewrites PYTEST_CURRENT_TEST for every test phase
        "environ": {k: v for k, v in os.environ.items() if k != "PYTEST_CURRENT_TEST"},
    }


@pytest.fixture(scope="module", autouse=True)
def leaves_process_as_found():
    before = _state()
    threads = torch.get_num_threads()
    rng_state = torch.random.get_rng_state()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        torch.random.set_rng_state(rng_state)
    after = _state()
    changed = {k: (before[k], after[k]) for k in before if before[k] != after[k]}
    if "environ" in changed:
        b, a = changed["environ"]
        changed["environ"] = {k: (b.get(k), a.get(k)) for k in set(b) | set(a)
                              if b.get(k) != a.get(k)}
    assert not changed, f"port test file changed process state: {changed}"


def randomize(tree, seed: int, scale: float = 0.05):
    """Replace every leaf of a flax param tree with seeded non-zero numpy
    values: N(0, scale^2), and 1 + N(0, scale^2) for norm scales."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        name = str(getattr(path[-1], "key", path[-1]))
        v = scale * rng.standard_normal(np.shape(leaf)).astype(np.float32)
        leaves.append(1.0 + v if name == "scale" else v)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def rel_err(got, want) -> float:
    """max |got - want| / max(|want|, 1e-6), both as float64 numpy."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6))


def to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)
