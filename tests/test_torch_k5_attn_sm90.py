"""K5 attn's GEMMs on wgmma + TMA (``csrc/gemm_sm90.cuh``'s NN and TN
layouts, launched by ``csrc/dit_block_train.cu``'s
``lfm_dit_block_train_attn_bwd``) on the CPU: the NN store into bf16 (do =
bf16(bf16(dpr) Wproj), the instance this layout adds) against jnp as
lfm_tpu/kernels/dit_block_train.py's `_attn_bwd_kernel` writes it, the
wrappers' refusals, the kernel's tile rule at K5 attn's four products over
every DiT width and the train batches, K5 attn's four products through the
NN / TN wrappers against the plain version's own, and the plain version
(``reference_attn_bwd``) against JAX's `_attn_bwd_call` in interpret mode
at two widths. The GEMMs sum in f32 with no split of K and no atomics, and
K5 attn's other sums (dbqkv, dbproj, dmod) are the kernels K5 had before,
so there is no new sum order to emulate. The kernels themselves run only on
the card (tests/test_torch_cuda.py).

Tolerances: an f32 output within 1e-5 of its largest value (f32 sums of the
same exact bf16 products in another order), a bf16 output within one bf16
ulp of its largest value (2^-7: such a sum rounds the other way now and
then); K5 attn's outputs within 5e-3 of JAX's, as
tests/test_torch_dit_block_train.py holds the plain version (the same
inputs and rounding points, f32 sums in another order).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.experimental.pallas  # noqa: E402,F401  (sets CUDA_ROOT when first imported)
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found, rel_err, to_np  # noqa: E402,F401
from tests.test_torch_k5_mlp_sm90 import (DIT_WIDTHS, TOKENS, TRAIN_BATCHES,  # noqa: E402
                                          _bf16, _jnp_dot)

from lfm_tpu.kernels import dit_block_train as jk  # noqa: E402
from lfm_tpu_torch.kernels import dit_block_train as tk  # noqa: E402
from lfm_tpu_torch.kernels import gemm as tg  # noqa: E402

BF = torch.bfloat16
F32_TOL, BF16_TOL, ATTN_TOL = 1e-5, 2.0 ** -7, 5e-3
OUTPUTS = ("dx", "dmod", "dwqkv", "dbqkv", "dwproj", "dbproj")


# (M, K, N): do's shape at small sizes, M and K ending inside a tile and a k
# step, N at 128 and 256 columns
@pytest.mark.parametrize("m,k,n", [(300, 200, 384), (192, 128, 128), (128, 256, 256)])
def test_reference_gemm_nn_into_bf16_matches_jnp(m, k, n):
    """The NN store into bf16 against jnp as `_attn_bwd_kernel` writes do:
    bf16 operands, dot_general into f32, rounded once to bf16."""
    rng = np.random.default_rng(m + 2 * k + n)
    a, b = _bf16(rng, (m, k)), _bf16(rng, (k, n), k ** -0.5)
    got = tg.reference_gemm_nn(*(torch.from_numpy(x).to(BF) for x in (a, b)), out_dtype=BF)
    want = np.asarray(_jnp_dot(a, b).astype(jnp.bfloat16), np.float32)
    assert got.dtype == BF and got.shape == (m, n)
    assert rel_err(to_np(got.float()), want) < BF16_TOL


def test_gemm_nn_tn_refuse_what_k5_attn_does_not_take():
    """The wrappers' checks at K5 attn's products, the same on every device:
    only the NN store writes bf16 (no TN or float16 out), and the NN / TN
    shape rules hold for it."""
    z = lambda *s: torch.zeros(*s, dtype=BF)  # noqa: E731
    got = tg.gemm_nn(z(64, 128), z(128, 256), out_dtype=BF)
    assert got.dtype == BF and got.shape == (64, 256)
    with pytest.raises(ValueError, match="nn store writes float32 or bfloat16"):
        tg.gemm_nn(z(64, 128), z(128, 256), out_dtype=torch.float16)
    with pytest.raises(ValueError, match="tn store writes float32"):
        tg._gemm_bwd("tn", z(128, 64), z(128, 256), "store", None, BF)
    with pytest.raises(ValueError, match="N % 128"):
        tg.gemm_nn(z(64, 128), z(128, 192), out_dtype=BF)
    with pytest.raises(ValueError, match="K % 8"):
        tg.gemm_nn(z(64, 100), z(100, 256), out_dtype=BF)
    with pytest.raises(ValueError, match="M % 8"):
        tg.gemm_tn(z(64, 100), z(64, 128))


@pytest.mark.parametrize("batch", TRAIN_BATCHES)
@pytest.mark.parametrize("c", DIT_WIDTHS)
def test_k5_attn_gemm_tiles_over_dit_widths(c, batch):
    """gemm_tile (the mirror of gemm_sm90.cuh's tile_n and launch_bn) at K5
    attn's four products, every DiT width, the train batches: do (M, C),
    dWproj (C, C), dhb (M, C), dWqkv (3C, C). The width divides N, is 256
    unless N % 256 != 0 or 128-wide tiles end the busiest SM's work more
    than 1/8 sooner, and the grid is one persistent CTA an SM, at most one a
    tile. With no split of K dWproj is the small case: at DiT-L/2's (C 1024,
    N = 32) 64 tiles of 128 x 128 for 132 SMs, dWqkv 96 of 128 x 256."""
    m = batch * TOKENS
    for rows, cols in ((m, c), (c, c), (m, c), (3 * c, c)):
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
        assert tg.gemm_tile(c, c) == (128, 64) and tg.gemm_tile(3 * c, c) == (256, 96)
        assert tg.gemm_tile(m, c) == (256, 132)


def _attn_case(n, t, c, heads, seed):
    """K5 attn's inputs (bf16, torch layout) on the plain forward's streams,
    and `_attn_bwd_call`'s outputs in interpret mode (one sample a cell),
    jitted, with flax's (in, out) weight gradients in torch's layout."""
    rng = np.random.default_rng(seed)
    hidden = 4 * c
    tt = {k: torch.from_numpy(_bf16(rng, s, sc)).to(BF)
          for k, s, sc in (("x", (n, t, c), 1.0), ("mod", (n, 6 * c), 0.2),
                           ("wqkv", (3 * c, c), 0.05), ("bqkv", (3 * c,), 0.05),
                           ("wproj", (c, c), 0.05), ("bproj", (c,), 0.05),
                           ("w1", (hidden, c), 0.05), ("b1", (hidden,), 0.05),
                           ("w2", (c, hidden), 0.05), ("b2", (c,), 0.05),
                           ("dx1", (n, t, c), 1.0))}
    _, _, _, pr, qkv, ao, _ = tk.reference_block_fwd_streams(
        *(tt[k] for k in ("x", "mod", "wqkv", "bqkv", "wproj", "bproj", "w1", "b1", "w2",
                          "b2")), num_heads=heads)
    args = (tt["x"], tt["mod"], pr, qkv, ao, tt["wqkv"], tt["wproj"], tt["dx1"])

    def j(a, transpose=False):
        a = to_np(a.float())
        return jnp.asarray(a.T if transpose else a, jnp.bfloat16)

    call = jax.jit(lambda *a: jk._attn_bwd_call(*a, num_heads=heads, s_cell=1))
    with pltpu.force_tpu_interpret_mode():
        out = call(j(tt["x"]), j(tt["mod"]).reshape(n, 6, c), j(pr), j(qkv), j(ao),
                   j(tt["wqkv"], True), j(tt["wproj"], True), j(tt["dx1"]))
    dx, dmod, dwqkv, dbqkv, dwproj, dbproj = (np.asarray(a, np.float32) for a in out)
    return args, (dx, dmod, dwqkv.T, dbqkv, dwproj.T, dbproj)


# two widths: JAX's test width (C 128, 4 heads of 32) and DiT-S/2's head
# dim (C 256, 4 heads of 64); T 64 at N 3 (192 token rows: a ragged 128-row
# tile)
@pytest.fixture(scope="module", params=[(3, 64, 128, 4), (2, 64, 256, 4)],
                ids=["c128", "c256"])
def attn_case(request):
    n, t, c, heads = request.param
    return (heads,) + _attn_case(n, t, c, heads, seed=c + n)


def test_plain_attn_bwd_matches_pallas_kernel(attn_case):
    """K5 attn's plain version against JAX's `_attn_bwd_call`: all six
    outputs."""
    heads, args, want = attn_case
    got = tk.reference_attn_bwd(*args, num_heads=heads)
    assert got[0].dtype == BF and got[2].dtype == torch.float32
    for name, g, w in zip(OUTPUTS, got, want):
        assert tuple(g.shape) == w.shape, name
        assert rel_err(to_np(g.float()), w) < ATTN_TOL, (name, rel_err(to_np(g.float()), w))


def test_gemm_nn_tn_run_k5_attns_products(attn_case):
    """The four products of K5 attn through the NN / TN wrappers (their
    plain versions on the CPU) against the plain version's own: do (NN into
    bf16), dWproj (TN), dhb (NN into f32) and dWqkv (TN)."""
    heads, args, _ = attn_case
    x, mod, pr, qkv, ao, wqkv, wproj, dx1 = args
    n, t, c = x.shape
    rows = n * t
    _, _, dwqkv, _, dwproj, _ = tk.reference_attn_bwd(*args, num_heads=heads)
    sh, sc, g = tk._mod_vectors(mod, n, c)[:3]
    n1, _ = tk._ln_fwd_parts(x.float())
    hb = (n1 * (1.0 + sc) + sh).to(BF).reshape(rows, c)
    dprb = (dx1.float() * g).to(BF).reshape(rows, c)
    do = tg.gemm_nn(dprb, wproj, out_dtype=BF)
    assert do.dtype == BF and torch.equal(do, tk._mm_f32(dprb, wproj).to(BF))
    assert rel_err(to_np(tg.gemm_tn(dprb, ao.reshape(rows, c))), to_np(dwproj)) < F32_TOL
    q, k, v = tk.split_qkv(qkv, heads)
    dqkv = torch.stack(tk.reference_attention_bwd(q, k, v, do.reshape(q.shape)),
                       dim=2).reshape(rows, 3 * c)
    assert rel_err(to_np(tg.gemm_tn(dqkv, hb)), to_np(dwqkv)) < F32_TOL
    dhb = tg.gemm_nn(dqkv, wqkv)
    assert dhb.dtype == torch.float32
    assert rel_err(to_np(dhb), to_np(tk._mm_f32(dqkv, wqkv))) < F32_TOL
