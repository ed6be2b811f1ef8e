"""Port parity: lfm_tpu_torch DiT, the kernels' plain versions and the fused
DiT forward against lfm_tpu, on the CPU at a small size (16x16 latents,
patch 2, hidden 128, 4 heads, depth 2-3).

The JAX Pallas kernels run in interpret mode, as tests/test_kernels.py and
tests/test_dit_fused.py run them. Weights come from a numpy seed, every
tensor non-zero. Tolerances: f32 DiT 1e-5 relative (same arithmetic, other
reduction order); f32 attention 2e-5 (tests/test_kernels.py); bf16 paths
5e-2 relative to the largest output (tests/test_dit_fused.py), since a
single bf16 rounding that falls the other way moves a value by 2^-8.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tests.torch_parity import leaves_process_as_found, randomize, rel_err, to_np  # noqa: E402,F401

from lfm_tpu.kernels import dit_block as jblock  # noqa: E402
from lfm_tpu.kernels import flash_attention as jattn  # noqa: E402
from lfm_tpu.nn import dit as jdit  # noqa: E402
from lfm_tpu.nn import dit_fused as jfused  # noqa: E402
from lfm_tpu_torch.kernels import dit_block as tblock  # noqa: E402
from lfm_tpu_torch.kernels import flash_attention as tattn  # noqa: E402
from lfm_tpu_torch.nn import dit as tdit  # noqa: E402
from lfm_tpu_torch.nn import dit_fused as tfused  # noqa: E402
from lfm_tpu_torch.nn.convert_dit import dit_params_from_jax  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 5e-2
SMALL = dict(img_resolution=16, patch_size=2, in_channels=4, hidden_size=128, num_heads=4)


def _pair(depth, dtype_j, dtype_t, num_classes=10, label_dropout=0.0, seed=0):
    """A JAX DiT with randomized params and the port's DiT holding them."""
    jm = jdit.DiT(**SMALL, depth=depth, num_classes=num_classes, label_dropout=label_dropout,
                  dtype=dtype_j, scan_blocks=True)
    x = jnp.zeros((1, 16, 16, 4))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1,)), x, jnp.zeros((1,), jnp.int32))
    params = randomize(params, seed)
    tm = tdit.DiT(**SMALL, depth=depth, num_classes=num_classes, label_dropout=label_dropout,
                  dtype=dtype_t)
    tm.load_state_dict(dit_params_from_jax(params))
    return jm, params, tm.eval()


def _inputs(n=4, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 16, 16, 4)).astype(np.float32)
    t = np.linspace(0.1, 0.9, n).astype(np.float32)
    y = np.array([0, 3, 5, 9][:n])
    return x, t, y


def test_dit_forward_f32_parity():
    jm, params, tm = _pair(depth=2, dtype_j=jnp.float32, dtype_t=torch.float32)
    x, t, y = _inputs()
    want = jm.apply(params, jnp.asarray(t), jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (4, 16, 16, 4) and got.dtype == torch.float32
    assert rel_err(got, want) < F32_TOL
    # y=None takes the null row, as in the JAX module
    want0 = jm.apply(params, jnp.asarray(t), jnp.asarray(x))
    with torch.no_grad():
        got0 = tm(torch.from_numpy(t), torch.from_numpy(x))
    assert rel_err(got0, want0) < F32_TOL


def test_dit_forward_bf16_module_path_parity():
    """The bf16 module path with attention through attention_small (its plain
    version on the CPU) against the JAX bf16 module."""
    jm, params, tm = _pair(depth=2, dtype_j=jnp.bfloat16, dtype_t=torch.bfloat16,
                           num_classes=1, label_dropout=0.0)
    tm_flash = tdit.DiT(**SMALL, depth=2, num_classes=1, dtype=torch.bfloat16, use_flash=True)
    tm_flash.load_state_dict(tm.state_dict())
    x, t, _ = _inputs()
    want = jm.apply(params, jnp.asarray(t), jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(x))
        got_flash = tm_flash(torch.from_numpy(t), torch.from_numpy(x))
    assert rel_err(got, want) < BF16_TOL
    assert rel_err(got_flash, want) < BF16_TOL


def test_forward_with_cfg_parity():
    jm, params, tm = _pair(depth=2, dtype_j=jnp.float32, dtype_t=torch.float32,
                           num_classes=10, label_dropout=0.1)
    x, t, y = _inputs(n=2)
    x2 = np.concatenate([x, x])
    t2 = np.concatenate([t, t])
    y2 = np.concatenate([y, np.full_like(y, jm.null_label)])
    want = jm.forward_with_cfg(params, jnp.asarray(t2), jnp.asarray(x2), jnp.asarray(y2), 1.5)
    with torch.no_grad():
        got = tm.forward_with_cfg(torch.from_numpy(t2), torch.from_numpy(x2),
                                  torch.from_numpy(y2), 1.5)
    assert tm.null_label == jm.null_label == 10
    assert rel_err(got, want) < F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_attention_matches_jax_attention_small(dtype):
    """The plain version of K1 against the JAX Pallas kernel in interpret
    mode (tests/test_kernels.py:177-189)."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 128, 4, 64)).astype(np.float32) for _ in range(3))
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.attention_small(*(jnp.asarray(a, jd) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    got = tattn.reference_attention(tq, tk, tv)
    tol = 2e-5 if dtype == "float32" else BF16_TOL
    assert rel_err(to_np(got), np.asarray(want, np.float32)) < tol
    # on a CPU tensor the wrapper is the plain version, inside and past the
    # gate (there K4's, which agrees with K1's to f32 rounding)
    assert torch.equal(tattn.attention_small(tq, tk, tv), got)
    assert torch.equal(tattn.fused_attention(tq, tk, tv), got)
    long = torch.from_numpy(rng.standard_normal((1, 1032, 1, 8)).astype(np.float32))
    assert not tattn._small_shape_ok(long)
    assert torch.equal(tattn.fused_attention(long, long, long),
                       tattn.reference_flash_attention(long, long, long))
    assert rel_err(to_np(tattn.fused_attention(long, long, long)),
                   to_np(tattn.reference_attention(long, long, long))) < 1e-5


def _block_args(n=4, t=64, c=128, heads=4, seed=3):
    rng = np.random.default_rng(seed)
    hidden = 4 * c
    shapes = dict(x=(n, t, c), mod=(n, 6 * c), wqkv=(c, 3 * c), bqkv=(3 * c,), wproj=(c, c),
                  bproj=(c,), w1=(c, hidden), b1=(hidden,), w2=(hidden, c), b2=(c,))
    scale = dict(x=1.0, mod=0.2)
    return {k: (scale.get(k, 0.05) * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def test_reference_block_matches_jax_fused_dit_block():
    """The plain version of K2 against the JAX Pallas block kernel in
    interpret mode (tests/test_dit_fused.py:15-47); weights go to the port
    in torch.nn.Linear layout (out, in)."""
    a = _block_args()
    with pltpu.force_tpu_interpret_mode():
        want = jblock.fused_dit_block(
            *(jnp.asarray(a[k], jnp.bfloat16) for k in
              ("x", "mod", "wqkv", "bqkv", "wproj", "bproj", "w1", "b1", "w2", "b2")),
            num_heads=4, samples_per_cell=2)

    def tt(k, transpose=False):
        v = a[k].T if transpose else a[k]
        return torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16)

    args = (tt("x"), tt("mod"), tt("wqkv", True), tt("bqkv"), tt("wproj", True), tt("bproj"),
            tt("w1", True), tt("b1"), tt("w2", True), tt("b2"))
    got = tblock.reference_block(*args, num_heads=4)
    assert got.dtype == torch.bfloat16 and got.shape == (4, 64, 128)
    assert rel_err(to_np(got), np.asarray(want, np.float32)) < BF16_TOL
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(tblock.fused_dit_block(*args, num_heads=4), got)


def test_dit_fused_apply_matches_jax():
    """The whole fused forward in bf16: the port's dit_fused_apply (plain
    block version on the CPU) against lfm_tpu's dit_fused_apply with the
    Pallas block in interpret mode, and against the port's module path."""
    jm, params, tm = _pair(depth=3, dtype_j=jnp.bfloat16, dtype_t=torch.bfloat16)
    x, t, y = _inputs()
    with pltpu.force_tpu_interpret_mode():
        want = jfused.dit_fused_apply(jm, jfused.cast_params_bf16(params), jnp.asarray(t),
                                      jnp.asarray(x), jnp.asarray(y))
    bf = tfused.cast_params_bf16(tm.state_dict())
    assert all(v.dtype == torch.bfloat16 for v in bf.values())
    got = tfused.dit_fused_apply(tm, bf, torch.from_numpy(t), torch.from_numpy(x),
                                 torch.from_numpy(y))
    assert got.shape == (4, 16, 16, 4) and got.dtype == torch.float32
    assert rel_err(got, want) < BF16_TOL
    with torch.no_grad():
        module = tm(torch.from_numpy(t), torch.from_numpy(x), torch.from_numpy(y))
    assert rel_err(got, module) < BF16_TOL


def test_fused_applicable_gate():
    x = torch.zeros(2, 16, 16, 4)
    bf = tdit.DiT(**SMALL, depth=1, dtype=torch.bfloat16)
    assert tfused.fused_applicable(bf, x)
    assert not tfused.fused_applicable(tdit.DiT(**SMALL, depth=1), x)  # f32 keeps f32 numerics
    odd = tdit.DiT(img_resolution=16, patch_size=2, hidden_size=96, depth=1, num_heads=4,
                   dtype=torch.bfloat16)
    assert not tfused.fused_applicable(odd, x)  # d % 128 != 0


@pytest.mark.parametrize("name", sorted(tdit.DIT_CONFIGS))
def test_create_dit_matches_jax_param_shapes(name, monkeypatch, tmp_path):
    """All 12 DiT configs: the port's parameters (built on the meta device,
    no memory) hold exactly the JAX model's parameter count, and the DiT-L/2
    of the main path passes the fused gate."""
    # the meta device imports torch._inductor, which sets this variable if
    # it is unset; pin it for the test so the process keeps its environment
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path))
    tm = tdit.create_dit(name, img_resolution=32, num_classes=1, dtype=torch.bfloat16,
                         device="meta")
    jm = jdit.create_dit(name, img_resolution=32, num_classes=1)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1,)),
                            jnp.zeros((1, 32, 32, 4)))
    j_count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in tm.parameters()) == j_count
    assert (tm.depth, tm.hidden_size, tm.patch_size, tm.num_heads) == tdit.DIT_CONFIGS[name]
    if name == "DiT-L/2":
        assert tfused.fused_applicable(tm, torch.zeros(2, 32, 32, 4, device="meta"))


def test_converted_state_dict_uses_reference_names():
    """dit_params_from_jax is the inverse of lfm_tpu's reference-checkpoint
    converter: feeding the port's state_dict (reference key names) to
    lfm_tpu.nn.convert_dit gives back the original flax params."""
    from lfm_tpu.nn.convert_dit import convert_dit_state_dict

    _, params, tm = _pair(depth=2, dtype_j=jnp.float32, dtype_t=torch.float32)
    back = convert_dit_state_dict(tm.state_dict(), depth=2)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_b[path]))
