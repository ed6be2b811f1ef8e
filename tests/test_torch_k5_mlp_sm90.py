"""K5 mlp's GEMMs on wgmma + TMA (``csrc/gemm_sm90.cuh``'s NN and TN
layouts) on the CPU: the plain versions of ``kernels/gemm.py``'s
``gemm_nn`` and ``gemm_tn`` against the same products written with jnp as
lfm_tpu/kernels/dit_block_train.py's `_mlp_bwd_kernel` writes them, their
refusals, the kernel's tile rule over every DiT width, and the kernel's
fixed-order sums (``EPI_DGELU``'s column partials, then
``reduce_rows_kernel``) written out in torch, bit for bit against the
order they name and, inside K5 mlp, against the plain version
(``reference_mlp_bwd``, whose products are ``_mm_f32``) and JAX's
`_mlp_bwd_call` in interpret mode. No split of K is kept (a weight
gradient's 8192 token rows run in one CTA per tile), so there is none to
emulate. The kernels themselves run only on the card
(tests/test_torch_cuda.py).

Tolerances: an f32 output within 1e-5 of its largest value (f32 sums of
the same exact bf16 products in another order), a bf16 output within one
bf16 ulp of its largest value (2^-7: such a sum, or XLA's and torch's
tanh, rounds the other way now and then); K5 mlp's outputs within 5e-3 of
JAX's, as tests/test_torch_dit_block_train.py holds the plain version
(the same inputs and rounding points, f32 sums in another order).
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
from lfm_tpu_torch.kernels import gemm as tg  # noqa: E402

BF = torch.bfloat16
F32_TOL, BF16_TOL, MLP_TOL = 1e-5, 2.0 ** -7, 5e-3
DIT_WIDTHS = (384, 768, 1024, 1152)  # DiT-S, B, L, XL; hidden 4C
TRAIN_BATCHES = (8, 32, 160)  # chip_smoke.py's N = 8; DiT-L/2's and DiT-B/2's presets
TOKENS = 256  # a 256 px DiT's patch grid


def _bf16(rng, shape, scale=1.0) -> np.ndarray:
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(x).to(BF).float().numpy()


def emulate_dgelu_parts(du: torch.Tensor) -> torch.Tensor:
    """part (ceil(M / 128), N) as dgelu_column_sums forms it from f32 du:
    per 128-row tile, two warpgroups of 64 rows, four warps of 16 rows; a
    thread adds its rows r and r + 8 (r = 0..7), the warp's 8 row groups
    add as a tree ((v0 + v1) + (v2 + v3)) + ((v4 + v5) + (v6 + v7))
    (shuffles xor 4, 8, 16), the 4 warps in order, then warpgroup 1 plus
    warpgroup 2. Rows past M are zero."""
    m, n = du.shape
    tiles = -(-m // 128)
    x = torch.nn.functional.pad(du, (0, 0, 0, tiles * 128 - m)).view(tiles, 2, 4, 16, n)
    v = x[:, :, :, :8] + x[:, :, :, 8:]
    v = v[:, :, :, 0::2] + v[:, :, :, 1::2]
    v = v[:, :, :, 0::2] + v[:, :, :, 1::2]
    v = v[:, :, :, 0] + v[:, :, :, 1]
    wg = ((v[:, :, 0] + v[:, :, 1]) + v[:, :, 2]) + v[:, :, 3]
    return wg[:, 0] + wg[:, 1]


def emulate_reduce_rows(part: torch.Tensor) -> torch.Tensor:
    """reduce_rows_kernel: out[c] = ((0 + part[0, c]) + part[1, c]) + ..."""
    out = torch.zeros(part.shape[1])
    for p in range(part.shape[0]):
        out = out + part[p]
    return out


def emulate_mlp_bwd(x1, mod, h2, u, w1, w2, dy):
    """K5 mlp as the card computes it: reference_mlp_bwd's rounding points
    and products, with db1 the kernel's sums (emulate_dgelu_parts, then
    emulate_reduce_rows) of du."""
    got = list(tk.reference_mlp_bwd(x1, mod, h2, u, w1, w2, dy))
    n, t, c = x1.shape
    sc, g = tk._mod_vectors(mod, n, c)[4:]
    dh2b = (dy.float() * g).to(BF).reshape(n * t, c)
    uf = u.float().reshape(n * t, -1)
    du = tk._mm_f32(dh2b, w2) * tk._gelu_tanh_grad(uf, tk._gelu_tanh(uf)[1])
    got[3] = emulate_reduce_rows(emulate_dgelu_parts(du))
    return tuple(got)


def test_dgelu_column_sums_are_the_kernels_order():
    """emulate_dgelu_parts bit for bit against the order it names, step by
    step in numpy f32, on values whose sum depends on the order, with M
    ending inside a tile; and emulate_reduce_rows against its loop."""
    rng = np.random.default_rng(3)
    m, n = 300, 8
    x = (rng.standard_normal((m, n)) * 10.0 ** rng.integers(-4, 5, (m, n))).astype(np.float32)
    xp = np.zeros((384, n), np.float32)
    xp[:m] = x
    want = np.zeros((3, n), np.float32)
    for tile in range(3):
        for col in range(n):
            halves = []
            for wg in range(2):
                total = None
                for w in range(4):
                    base = tile * 128 + wg * 64 + w * 16
                    v = [np.float32(xp[base + r, col] + xp[base + r + 8, col]) for r in range(8)]
                    a = [np.float32(v[2 * i] + v[2 * i + 1]) for i in range(4)]
                    b = [np.float32(a[0] + a[1]), np.float32(a[2] + a[3])]
                    warp = np.float32(b[0] + b[1])
                    total = warp if total is None else np.float32(total + warp)
                halves.append(total)
            want[tile, col] = np.float32(halves[0] + halves[1])
    part = emulate_dgelu_parts(torch.from_numpy(x))
    assert part.numpy().tobytes() == want.tobytes()
    acc = np.zeros(n, np.float32)
    for p in range(3):
        acc = (acc + want[p]).astype(np.float32)
    assert emulate_reduce_rows(part).numpy().tobytes() == acc.tobytes()


@pytest.fixture(scope="module")
def mlp_case():
    """K5 mlp's inputs at JAX's test sizes (N 3, T 64: 192 token rows, the
    second 128-row tile ragged; C 128, hidden 512) on the plain forward's
    streams, and `_mlp_bwd_call`'s outputs in interpret mode, jitted."""
    n, t, c, hidden = 3, 64, 128, 512
    rng = np.random.default_rng(11)
    x = _bf16(rng, (n, t, c))
    mod = _bf16(rng, (n, 6 * c), 0.2)
    w = {k: _bf16(rng, s, 0.05) for k, s in (("wqkv", (3 * c, c)), ("bqkv", (3 * c,)),
                                             ("wproj", (c, c)), ("bproj", (c,)),
                                             ("w1", (hidden, c)), ("b1", (hidden,)),
                                             ("w2", (c, hidden)), ("b2", (c,)))}
    dy = _bf16(rng, (n, t, c))
    tt = {k: torch.from_numpy(v).to(BF) for k, v in dict(x=x, mod=mod, dy=dy, **w).items()}
    _, x1, h2, _, _, _, u = tk.reference_block_fwd_streams(
        tt["x"], tt["mod"], *(tt[k] for k in ("wqkv", "bqkv", "wproj", "bproj", "w1", "b1",
                                              "w2", "b2")), num_heads=2)
    args = (x1, tt["mod"], h2, u, tt["w1"], tt["w2"], tt["dy"])

    def j(a, transpose=False):
        a = to_np(a.float())
        return jnp.asarray(a.T if transpose else a, jnp.bfloat16)

    call = jax.jit(lambda *a: jk._mlp_bwd_call(*a, s_cell=1))
    with pltpu.force_tpu_interpret_mode():
        out = call(j(x1), j(tt["mod"]).reshape(n, 6, c), j(h2), j(u), j(tt["w1"], True),
                   j(tt["w2"], True), j(tt["dy"]))
    dx1, dmod, dw1, db1, dw2, db2 = (np.asarray(a, np.float32) for a in out)
    # flax's (in, out) weight gradients in torch.nn.Linear's layout
    return args, (dx1, dmod, dw1.T, db1, dw2.T, db2)


def test_emulated_mlp_bwd_matches_plain_and_pallas(mlp_case):
    """K5 mlp with the kernel's db1 sums against the plain version and JAX's
    `_mlp_bwd_call`: all six outputs."""
    args, want = mlp_case
    got = emulate_mlp_bwd(*args)
    plain = tk.reference_mlp_bwd(*args)
    for name, g, p, w in zip(("dx1", "dmod", "dw1", "db1", "dw2", "db2"), got, plain, want):
        assert tuple(g.shape) == w.shape, name
        assert rel_err(to_np(g.float()), to_np(p.float())) < F32_TOL, name
        assert rel_err(to_np(g.float()), w) < MLP_TOL, name


def test_gemm_nn_tn_run_k5_mlps_products(mlp_case):
    """The four products of K5 mlp through the NN / TN wrappers (their plain
    versions on the CPU) against the plain version's own: du, db1 and gb
    (dgelu), dW2, dh and dW1."""
    args, _ = mlp_case
    x1, mod, h2, u, w1, w2, dy = args
    n, t, c = x1.shape
    rows = n * t
    _, _, dw1, db1, dw2, _ = tk.reference_mlp_bwd(*args)
    sh, sc, g = tk._mod_vectors(mod, n, c)[3:]
    n2, _ = tk._ln_fwd_parts(x1.float())
    h2b = (n2 * (1.0 + sc) + sh).to(BF).reshape(rows, c)
    gb = tk._gelu_tanh(u.float().reshape(rows, -1))[0].to(BF)
    dh2b = (dy.float() * g).to(BF).reshape(rows, c)
    du, part, gb2 = tg.gemm_nn(dh2b, w2, epilogue="dgelu", u=u.reshape(rows, -1))
    assert du.dtype == BF and part.shape == (2, w1.shape[0]) and torch.equal(gb2, gb)
    assert rel_err(to_np(part.sum(dim=0)), to_np(db1)) < F32_TOL
    assert rel_err(to_np(tg.gemm_tn(dh2b, gb)), to_np(dw2)) < F32_TOL
    assert rel_err(to_np(tg.gemm_tn(du, h2b)), to_np(dw1)) < F32_TOL
    dh = tg.gemm_nn(du, w1)
    assert dh.dtype == torch.float32 and rel_err(to_np(dh), to_np(tk._mm_f32(du, w1))) < F32_TOL


def _jnp_dot(a, b):
    return jax.lax.dot_general(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                               (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)


# (layout, epilogue, M, K, N): M and K ending inside a tile and a k step,
# and N at 128 and 256 columns
PLAIN_CASES = [("nn", "store", 300, 200, 384), ("nn", "dgelu", 300, 96, 256),
               ("nn", "dgelu", 128, 64, 512), ("tn", "store", 136, 200, 256),
               ("tn", "store", 384, 128, 128)]


@pytest.mark.parametrize("layout,epilogue,m,k,n", PLAIN_CASES)
def test_reference_gemm_nn_tn_match_jnp(layout, epilogue, m, k, n):
    """The plain versions against jnp as `_mlp_bwd_kernel` writes the
    products (bf16 operands, dot_general into f32; du = value *
    _gelu_tanh_grad(u), gb = _gelu_tanh(u)); dgelu's part against jnp's
    sums per 128 rows."""
    rng = np.random.default_rng(m + k + n)
    a = _bf16(rng, (m, k) if layout == "nn" else (k, m))
    b = _bf16(rng, (k, n), k ** -0.5)
    ta, tb = (torch.from_numpy(x).to(BF) for x in (a, b))
    if layout == "tn":
        got = tg.reference_gemm_tn(ta, tb)
        assert got.dtype == torch.float32 and rel_err(to_np(got), _jnp_dot(a.T, b)) < F32_TOL
        return
    value = _jnp_dot(a, b)
    if epilogue == "store":
        got = tg.reference_gemm_nn(ta, tb)
        assert got.dtype == torch.float32 and rel_err(to_np(got), np.asarray(value)) < F32_TOL
        return
    u = _bf16(rng, (m, n), 2.0)
    ju = jnp.asarray(u)
    gl, t = jk._gelu_tanh(ju)
    du = np.asarray(value * jk._gelu_tanh_grad(ju, t))
    got, part, gb = tg.reference_gemm_nn(ta, tb, epilogue="dgelu", u=torch.from_numpy(u).to(BF))
    assert got.dtype == BF and rel_err(to_np(got.float()), du) < BF16_TOL
    assert gb.dtype == BF and rel_err(to_np(gb.float()), np.asarray(gl)) < BF16_TOL
    rows = -(-m // 128) * 128
    want = np.pad(du, ((0, rows - m), (0, 0))).reshape(-1, 128, n).sum(axis=1)
    assert part.shape == want.shape and rel_err(to_np(part), want) < F32_TOL


def test_gemm_nn_tn_refuse_what_the_kernel_does_not_take():
    """The wrappers' checks, the same on every device."""
    z = lambda *s: torch.zeros(*s, dtype=BF)  # noqa: E731
    with pytest.raises(ValueError, match="N % 128"):
        tg.gemm_nn(z(64, 128), z(128, 192))
    with pytest.raises(ValueError, match="K % 8"):
        tg.gemm_nn(z(64, 100), z(100, 256))
    with pytest.raises(ValueError, match="M % 8"):
        tg.gemm_tn(z(128, 100), z(128, 256))
    with pytest.raises(ValueError, match=r"a must be \(K, M\)"):
        tg.gemm_tn(z(64, 128), z(128, 256))
    with pytest.raises(ValueError, match="dgelu needs u"):
        tg.gemm_nn(z(64, 128), z(128, 256), epilogue="dgelu")
    with pytest.raises(ValueError, match="takes epilogue 'store'"):
        tg._gemm_bwd("tn", z(64, 128), z(64, 256), "dgelu", z(128, 256))
    with pytest.raises(ValueError, match="u must be"):
        tg.gemm_nn(z(64, 128), z(128, 256), epilogue="dgelu", u=z(64, 128))
    with pytest.raises(ValueError, match="store takes no u"):
        tg.gemm_nn(z(64, 128), z(128, 256), u=z(64, 256))
    with pytest.raises(ValueError, match="b must be"):
        tg.gemm_nn(z(64, 128), torch.zeros(128, 256))
    with pytest.raises(ValueError, match="contiguous"):
        tg.gemm_tn(z(256, 128).t(), z(128, 256))


@pytest.mark.parametrize("batch", TRAIN_BATCHES)
@pytest.mark.parametrize("c", DIT_WIDTHS)
def test_k5_mlp_gemm_tiles_over_dit_widths(c, batch):
    """gemm_tile (the mirror of gemm_sm90.cuh's tile_n and launch_bn) at K5
    mlp's four products, every DiT width, the train batches: the width
    divides N, is 256 unless N % 256 != 0 or 128-wide tiles end the busiest
    SM's work more than 1/8 sooner, and the grid is one persistent CTA an SM,
    at most one a tile. With no split of K a weight gradient's tiles are
    its CTAs: at DiT-L/2's (C 1024, N = 32) 128 of 132 SMs."""
    hidden, m = 4 * c, batch * TOKENS
    for rows, cols in ((m, hidden), (c, hidden), (m, c), (hidden, c)):  # du, dW2, dh, dW1
        bn, ctas = tg.gemm_tile(rows, cols)
        tiles = -(-rows // 128) * (cols // bn)
        assert cols % bn == 0 and ctas == min(tiles, tg.SMS)
        if cols % 256:
            assert bn == 128
        else:
            def span(w):
                return -(-(-(-rows // 128) * (cols // w)) // tg.SMS) * w
            assert (bn == 128) == (8 * span(128) < 7 * span(256))
    if (c, batch) == (1024, 32):
        assert tg.gemm_tile(c, hidden) == tg.gemm_tile(hidden, c) == (256, 128)
        assert tg.gemm_tile(m, hidden) == tg.gemm_tile(m, c) == (256, 132)
    if c == 1152:  # N = 1152 is no multiple of 256
        assert tg.gemm_tile(c, hidden)[0] == tg.gemm_tile(m, c)[0] == 128
