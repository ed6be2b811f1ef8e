"""Port parity of K5, the differentiable fused DiT block, on the CPU: each
plain version of lfm_tpu_torch/kernels/dit_block_train.py against its
Pallas kernel in lfm_tpu/kernels/dit_block_train.py run in interpret mode,
and ``make_fused_block_train`` against JAX's in each of its three modes, at
JAX's test sizes (``_block_args`` of tests/test_dit_fused.py: N 4, T 64,
C 128, 4 heads, hidden 512) with grid cells of 2 samples. Inputs come from
numpy seeds and are rounded to bf16 alike on both sides; the port takes the
weights in torch.nn.Linear layout (flax's transposed) and returns its
weight gradients so.

Tolerances (max |port - JAX| / max |JAX| per tensor; measured in brackets):
- the forward's streams 1e-2 [at most 0.54%, pr]: the same rounding
  points, f32 sums in another order, so a few values round the other way
  by one bf16 ulp (2^-8 relative);
- the backward kernels' outputs 5e-3 [at most 0.05%]: the same inputs and
  rounding points, f32 sums in another order;
- the block's cotangents in each mode 2e-2 [at most 0.58%]: the streams'
  one-ulp differences carried through the backward, and on the CPU JAX's
  hybrid differentiates its plain attention through autograd while the
  port runs K3's plain version (p and ds rounded to bf16).
One JAX run per mode is shared through a module-scoped fixture.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.experimental.pallas  # noqa: E402,F401  (sets CUDA_ROOT when first imported)
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found, rel_err, to_np  # noqa: E402,F401

from lfm_tpu.kernels import dit_block_train as jk  # noqa: E402
from lfm_tpu_torch.kernels import dit_block_train as tk  # noqa: E402

N, T, C, HEADS, HIDDEN, CELL = 4, 64, 128, 4, 512, 2
NAMES = ("x", "mod", "wqkv", "bqkv", "wproj", "bproj", "w1", "b1", "w2", "b2")
WEIGHTS = ("wqkv", "wproj", "w1", "w2")  # flax (in, out), torch (out, in)
STREAM_TOL, KERNEL_TOL, BLOCK_TOL = 1e-2, 5e-3, 2e-2
MODES = {"full_hybrid": dict(), "full_pallas": dict(pallas_bwd=True),
         "slim_hybrid": dict(save_streams="slim")}


def _inputs(seed=0):
    """Flax-layout f32 numpy arrays (rounded to bf16 by both packages alike)
    and a cotangent dy."""
    rng = np.random.default_rng(seed)

    def a(shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    flax = dict(x=a((N, T, C), 1.0), mod=a((N, 6 * C), 0.2),
                wqkv=a((C, 3 * C), 0.05), bqkv=a((3 * C,), 0.05),
                wproj=a((C, C), 0.05), bproj=a((C,), 0.05),
                w1=a((C, HIDDEN), 0.05), b1=a((HIDDEN,), 0.05),
                w2=a((HIDDEN, C), 0.05), b2=a((C,), 0.05))
    return flax, a((N, T, C), 1.0)


def _j(a):
    return jnp.asarray(a, jnp.bfloat16)


def _t(a, transpose=False):
    a = np.asarray(a, np.float32)
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a)).to(torch.bfloat16)


def _torch_args(flax):
    return [_t(flax[k], transpose=k in WEIGHTS) for k in NAMES]


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX result the tests read, computed once."""
    flax, dy = _inputs()
    x, mod, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2 = (_j(flax[k]) for k in NAMES)
    mod3 = mod.reshape(N, 6, C)
    runs = {"flax": flax, "dy": dy}
    with pltpu.force_tpu_interpret_mode():
        for mode in ("full", "slim"):
            runs[f"fwd_{mode}"] = [np.asarray(s, np.float32) for s in jk._block_fwd_call(
                x, mod3, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2, num_heads=HEADS,
                s_cell=CELL, save_streams=mode)]
        _, x1, h2, pr, qkv, ao, u = (_j(s) for s in runs["fwd_full"])
        mlp = jk._mlp_bwd_call(x1, mod3, h2, u, w1, w2, _j(dy), s_cell=CELL)
        runs["mlp"] = [np.asarray(a, np.float32) for a in mlp]
        runs["attn"] = [np.asarray(a, np.float32) for a in jk._attn_bwd_call(
            x, mod3, pr, qkv, ao, wqkv, wproj, mlp[0], num_heads=HEADS, s_cell=CELL)]
        args = [_j(flax[k]) for k in NAMES]
        for name, kw in MODES.items():
            block = jk.make_fused_block_train(HEADS, CELL, CELL, **kw)
            out, vjp = jax.vjp(block, *args)
            runs[name] = (np.asarray(out, np.float32),
                          [np.asarray(g, np.float32) for g in vjp(_j(dy))])
    return runs


@pytest.mark.parametrize("mode", ["full", "slim"])
def test_fwd_streams_match_pallas_kernel(jax_runs, mode):
    """``block_train_fwd`` (its plain version on the CPU) writes every
    stream of `_block_fwd_call` in this mode."""
    got = tk.block_train_fwd(*_torch_args(jax_runs["flax"]), num_heads=HEADS,
                             save_streams=mode)
    want = jax_runs[f"fwd_{mode}"]
    names = (("out", "h2", "pr", "qkv") if mode == "slim"
             else ("out", "x1", "h2", "pr", "qkv", "ao", "u"))
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape, name
        assert rel_err(to_np(g), w) < STREAM_TOL, (mode, name, rel_err(to_np(g), w))


def test_mlp_bwd_matches_pallas_kernel(jax_runs):
    """``mlp_bwd`` against `_mlp_bwd_call`: dx1, the MLP half's dmod, dW1,
    db1, dW2, db2, on the JAX forward's own streams."""
    flax = jax_runs["flax"]
    _, x1, h2, _, _, _, u = (_t(s) for s in jax_runs["fwd_full"])
    got = tk.mlp_bwd(x1, _t(flax["mod"]), h2, u, _t(flax["w1"], True), _t(flax["w2"], True),
                     _t(jax_runs["dy"]))
    want = jax_runs["mlp"]
    want = [want[0], want[1], want[2].T, want[3], want[4].T, want[5]]
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for name, g, w in zip(("dx1", "dmod", "dw1", "db1", "dw2", "db2"), got, want):
        assert rel_err(to_np(g), w) < KERNEL_TOL, (name, rel_err(to_np(g), w))


def test_attn_bwd_matches_pallas_kernel(jax_runs):
    """``attn_bwd`` against `_attn_bwd_call`: dx, the MSA half's dmod,
    dWqkv, dbqkv, dWproj, dbproj, on the JAX forward's streams and its MLP
    half's dx1."""
    flax = jax_runs["flax"]
    _, _, _, pr, qkv, ao, _ = (_t(s) for s in jax_runs["fwd_full"])
    got = tk.attn_bwd(_t(flax["x"]), _t(flax["mod"]), pr, qkv, ao, _t(flax["wqkv"], True),
                      _t(flax["wproj"], True), _t(jax_runs["mlp"][0]), num_heads=HEADS)
    want = jax_runs["attn"]
    want = [want[0], want[1], want[2].T, want[3], want[4].T, want[5]]
    for name, g, w in zip(("dx", "dmod", "dwqkv", "dbqkv", "dwproj", "dbproj"), got, want):
        assert rel_err(to_np(g), w) < KERNEL_TOL, (name, rel_err(to_np(g), w))


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_block_train_matches_jax(jax_runs, mode):
    """``make_fused_block_train`` in (full, hybrid), (full, pallas_bwd) and
    (slim, hybrid): the output and all 10 cotangents against JAX's in the
    same mode."""
    block = tk.make_fused_block_train(HEADS, CELL, CELL, **MODES[mode])
    args = [a.requires_grad_(True) for a in _torch_args(jax_runs["flax"])]
    out = block(*args)
    out.backward(_t(jax_runs["dy"]))
    want_out, want_grads = jax_runs[mode]
    assert rel_err(to_np(out), want_out) < STREAM_TOL, rel_err(to_np(out), want_out)
    for name, a, w in zip(NAMES, args, want_grads):
        g = to_np(a.grad)
        w = w.T if name in WEIGHTS else w
        assert a.grad.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert rel_err(g, w) < BLOCK_TOL, (mode, name, rel_err(g, w))


def test_fused_block_train_refuses_a_batch_of_partial_cells():
    """JAX's grid takes N / cell whole cells; so does the port (the backward
    cell only with pallas_bwd)."""
    args = _torch_args(_inputs()[0])
    with pytest.raises(ValueError, match="cells"):
        tk.make_fused_block_train(HEADS, 3)(*args)
    with pytest.raises(ValueError, match="cells"):
        tk.make_fused_block_train(HEADS, 2, 3, pallas_bwd=True)(*args)
    with pytest.raises(ValueError, match="cells"):
        tk.make_fused_block_train(HEADS, 2, 0, pallas_bwd=True)(*args)
    tk.make_fused_block_train(HEADS, 2, 3)(*args)  # the hybrid takes no backward cell
