"""f32 K1 past T = 256 on the CPU: the port's plain ``attention_small``
against lfm_tpu's Pallas ``attention_small`` in interpret mode (as
tests/test_kernels.py runs it), the algorithm of its CUDA kernel
(``csrc/attention_long_f32.cuh``'s key-block kernel with the whole row one
block) written out in torch as the kernel runs it, against both, and a
mirror of ``lfm_attention_small``'s f32 route (csrc/attention.cu) with the
kernel's shared-memory layout. The kernel itself runs only on the card
(tests/test_torch_cuda.py).

The emulation follows the kernel's blocks and sum orders: a CTA's query
rows (64 up to T = 512, 32 past it), all T keys in ring stages of KS keys
(128 at DP 64, 64 at DP 80; zero past T), the row's exact max, l summed
over 16 key groups in the kernel's order (``key_group_sum``, checked bit
for bit in tests/test_torch_attention_f32_long.py), and p v in two thread
groups each taking half of every stage (DP 64) or a fresh partial per
stage (DP 80). Its products are torch's f32 matmuls: where the kernel runs
one FMA chain, they emulate its blocking (which keys go into one sum), not
the order inside the chain.

Tolerance: 1e-5 of the largest reference value (the same f32 arithmetic,
f32 sums in another order).
"""

import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found, rel_err, to_np  # noqa: E402,F401
from tests.test_torch_attention_f32_long import (_heads, _pad_keys, flash_layout,  # noqa: E402
                                                 key_group_sum)

from lfm_tpu.kernels import flash_attention as jattn  # noqa: E402
from lfm_tpu_torch.kernels import flash_attention as tattn  # noqa: E402

F32_TOL = 1e-5
# just past the row kernels' 256, ragged, either side of 512, the gate
LENGTHS = (257, 300, 512, 513, 1024)
HEAD_DIMS = (64, 72)  # DiT-S/B/L and DiT-XL (DP 64 and 80)
SMEM = 232448  # bytes of shared memory a CTA may have on the H100 (ATT_MAX_SMEM)
THREADS = 256


def _inputs(t, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, t, 2, d)).astype(np.float32))
            for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _pallas(t, d):
    """JAX's attention_small on the Pallas kernel in interpret mode, jitted."""
    q, k, v = (jnp.asarray(to_np(a)) for a in _inputs(t, d, seed=7 * t + d))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.jit(jattn.attention_small)(q, k, v))


def emulate_k1_long(q, k, v):
    """f32 K1 past T = 256 as flash_f32_kernel computes it with BK = T: per
    CTA of ``rows`` query rows (f32_k1_route), s = q k^T over all T keys,
    the row max m = scale max s (taken unscaled, scaled once), p = exp(scale
    s - m), l = sum p in the kernel's key-group order; the single block's
    alpha = exp(-inf - m) = 0, so l and acc are the block's own sums; at DP
    64 two groups each sum the p v of their half of every stage in one
    chain (here one product over those keys) and are added at the end,
    otherwise each stage's p v is a fresh partial added in order; o = acc /
    l."""
    n, t, h, d = q.shape
    name, rows, keys = tattn.f32_k1_route(t, d)
    assert name == "flash_f32_kernel" and t <= keys
    dp, ks, tc = flash_layout(d)
    width = -(-t // ks) * ks
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = _heads(q, k, v)
    vp = _pad_keys(vf, width, -2)
    out = []
    for r0 in range(0, t, rows):  # one CTA's query rows
        s = qf[:, :, r0:r0 + rows] @ kf.transpose(-1, -2)
        m = scale * s.amax(dim=-1)
        p = _pad_keys(torch.exp(scale * s - m[..., None]), width, -1)
        l = key_group_sum(p, tc)
        if dp == 64:  # group g's half of every stage, one chain each
            half = [torch.arange(c0, c0 + ks // 2) for c0 in range(0, width, ks)]
            idx = torch.cat(half)
            acc = p[..., idx] @ vp[:, :, idx] + p[..., idx + ks // 2] @ vp[:, :, idx + ks // 2]
        else:  # a fresh partial per stage
            acc = torch.zeros(n, h, s.shape[2], d)
            for c0 in range(0, width, ks):
                acc = acc + p[..., c0:c0 + ks] @ vp[:, :, c0:c0 + ks]
        out.append(acc / l[..., None])
    return torch.cat(out, dim=2).transpose(1, 2)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("t", LENGTHS)
def test_plain_f32_k1_matches_pallas_kernel(t, d):
    """The port's plain attention_small (its CPU path) against the Pallas
    kernel in f32 at N = 1, H = 2."""
    q, k, v = _inputs(t, d, seed=7 * t + d)
    got = tattn.attention_small(q, k, v)
    assert got.dtype == torch.float32 and got.shape == (1, t, 2, d)
    assert rel_err(to_np(got), _pallas(t, d)) < F32_TOL


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("t", LENGTHS)
def test_emulated_f32_k1_long_matches_plain_and_pallas(t, d):
    """The emulated kernel against the plain version and the Pallas kernel
    on the same inputs."""
    q, k, v = _inputs(t, d, seed=7 * t + d)
    got = emulate_k1_long(q, k, v)
    assert got.dtype == torch.float32 and got.shape == (1, t, 2, d)
    assert rel_err(to_np(got), to_np(tattn.reference_attention(q, k, v))) < F32_TOL
    assert rel_err(to_np(got), _pallas(t, d)) < F32_TOL


def flash_stage_keys(dp, bq):
    """FlashLayout<DP, BQ, KCAP>::KS, the keys of a ring stage: 128 at DP 64,
    64 at DP 80 and at DP 128 with 32 query rows, else 32."""
    return 128 if dp <= 64 else 64 if dp <= 80 or (dp <= 128 and bq <= 32) else 32


def _flash_bytes(dp, bq, kcap, ks=None):
    """FlashLayout<DP, BQ, KCAP>::BYTES: q (BQ rows of DP + 4 floats), the
    scores (BQ x KCAP + 4), two ring stages of KS rows (``ks``, or the
    layout's), two reductions."""
    ks = ks or flash_stage_keys(dp, bq)
    tc = ks // (8 if dp <= 64 else 4)
    ld = dp + 4
    return 4 * (bq * ld + bq * (kcap + 4) + 2 * ks * ld + 2 * (tc // 4) * bq)


def test_f32_k1_route_mirrors_attention_cu():
    """f32_k1_route, the Python mirror of lfm_attention_small's f32 route:
    D 128/256 take attention_wide.cu (one pass to T = 64, past it
    attention_long_f32.cuh's key-block kernel: tests/
    test_torch_attention_f32_k1_wide.py), D 56-80 the row kernels to T =
    256, then attention_long_f32.cuh's kernel with 64 query rows and 512
    keys to T = 512 and 32 rows and 1024 keys to the gate; every instance
    holds the whole row and fits one CTA's shared memory, and 64 rows of
    1024 keys would not."""
    for d in (56, 64, 72, 80):
        dp = 64 if d <= 64 else 80
        for t in (1, 64, 65, 128, 129, 256):
            name, rows, keys = tattn.f32_k1_route(t, d)
            assert name == "attn_row_kernel" and rows == 64 and t <= keys <= 256
        for t in (257, 300, 512, 513, 700, 1024):
            want = (64, 512) if t <= 512 else (32, 1024)
            assert tattn.f32_k1_route(t, d) == ("flash_f32_kernel",) + want
            assert t <= want[1] and _flash_bytes(dp, *want) <= SMEM
        assert _flash_bytes(dp, 64, 1024) > SMEM
        # p v's 8 x (DP / 4) output tiles fit twice in a CTA only at DP 64:
        # two thread groups there (SPLIT), as emulate_k1_long sums
        assert (2 * 8 * (dp // 4) <= THREADS) == (dp == 64)
    assert tattn.f32_k1_route(16, 128) == ("attn_short_f32_kernel", 16, 16)
    assert tattn.f32_k1_route(64, 256) == ("attn_short_f32_kernel", 32, 64)
    assert tattn.f32_k1_route(256, 128) == ("flash_f32_kernel", 64, 512)
    # the byte counts attention_long_f32.cuh's header states (206 / 182 KB)
    assert _flash_bytes(64, 32, 1024) == 210944 and _flash_bytes(80, 32, 1024) == 186368
