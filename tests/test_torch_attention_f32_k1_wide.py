"""f32 K1 at the origin ADM's wide heads (D = 128/256) past T = 64 on the
CPU: the port's plain ``attention_small`` against lfm_tpu's Pallas
``attention_small`` in interpret mode (as tests/test_kernels.py runs it),
the algorithm of its CUDA kernel (``csrc/attention_long_f32.cuh``'s
key-block kernel with the whole row one block, launched by
``csrc/attention_wide.cu``) written out in torch as the kernel runs it,
against both, the route mirror ``f32_k1_route`` with the kernel's
shared-memory layout over every T of the gate, and the origin ADM at test
scale with 128-wide heads through ``use_flash`` against JAX's on the same
weights. The kernel itself runs only on the card (tests/test_torch_cuda.py).

The emulation follows the kernel's blocks and sum orders: a CTA's query
rows (64 at D = 128 up to T = 512, else 32), all T keys in ring stages of
KS keys (32 at D = 128 with 64 rows and at D = 256, 64 at D = 128 with 32
rows; zero past T), the row's exact max, l summed over the key groups in
the kernel's order (``key_group_sum``, checked bit for bit in
tests/test_torch_attention_f32_long.py), and p v a fresh partial per stage
added in order. Its products are torch's f32 matmuls: where the kernel runs
one FMA chain, they emulate its blocking (which keys go into one sum), not
the order inside the chain.

Tolerances: 1e-5 of the largest reference value (the same f32 arithmetic,
f32 sums in another order); the ADM's velocity 1e-4 of JAX's in f32 and
5e-2 in bf16, tests/test_torch_adm.py's.
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
from tests.test_torch_adm import _forward_both, _pair  # noqa: E402
from tests.test_torch_attention_f32_k1_long import (_flash_bytes,  # noqa: E402
                                                    flash_stage_keys)
from tests.test_torch_attention_f32_long import _heads, _pad_keys, key_group_sum  # noqa: E402

from lfm_tpu.kernels import flash_attention as jattn  # noqa: E402
from lfm_tpu_torch.kernels import flash_attention as tattn  # noqa: E402
from lfm_tpu_torch.nn.adm_unet import ADMAttentionBlock  # noqa: E402

F32_TOL = 1e-5
# just past the one-pass kernel's 64, ragged, celeb512_adm's ds 4, either
# side of 512, celeb512_adm's ds 2 (the gate)
LENGTHS = (65, 100, 256, 513, 1024)
HEAD_DIMS = (128, 256)  # the origin ADM's heads
SMEM = 232448  # bytes of shared memory a CTA may have on the H100 (ATT_MAX_SMEM)


def _inputs(t, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, t, 2, d)).astype(np.float32))
            for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _pallas(t, d):
    """JAX's attention_small on the Pallas kernel in interpret mode, jitted."""
    q, k, v = (jnp.asarray(to_np(a)) for a in _inputs(t, d, seed=5 * t + d))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.jit(jattn.attention_small)(q, k, v))


def emulate_k1_wide(q, k, v):
    """f32 K1 at D = 128/256 past T = 64 as flash_f32_kernel computes it with
    BK = T: per CTA of ``rows`` query rows (f32_k1_route), s = q k^T over
    all T keys, the row max m = scale max s (taken unscaled, scaled once),
    p = exp(scale s - m), l = sum p in the kernel's key-group order (TC =
    KS / 4 groups); the single block's alpha = 0, so l and acc are the
    block's own sums; each stage's p v is a fresh partial added in order; o
    = acc / l."""
    n, t, h, d = q.shape
    name, rows, keys = tattn.f32_k1_route(t, d)
    assert name == "flash_f32_kernel" and t <= keys
    ks = flash_stage_keys(d, rows)
    width = -(-t // ks) * ks
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = _heads(q, k, v)
    vp = _pad_keys(vf, width, -2)
    out = []
    for r0 in range(0, t, rows):  # one CTA's query rows
        s = qf[:, :, r0:r0 + rows] @ kf.transpose(-1, -2)
        m = scale * s.amax(dim=-1)
        p = _pad_keys(torch.exp(scale * s - m[..., None]), width, -1)
        l = key_group_sum(p, ks // 4)
        acc = torch.zeros(n, h, s.shape[2], d)
        for c0 in range(0, width, ks):
            acc = acc + p[..., c0:c0 + ks] @ vp[:, :, c0:c0 + ks]
        out.append(acc / l[..., None])
    return torch.cat(out, dim=2).transpose(1, 2)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("t", LENGTHS)
def test_plain_f32_k1_wide_matches_pallas_kernel(t, d):
    """The port's plain attention_small (its CPU path) against the Pallas
    kernel in f32 at N = 1, H = 2."""
    q, k, v = _inputs(t, d, seed=5 * t + d)
    got = tattn.attention_small(q, k, v)
    assert got.dtype == torch.float32 and got.shape == (1, t, 2, d)
    assert rel_err(to_np(got), _pallas(t, d)) < F32_TOL


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("t", LENGTHS)
def test_emulated_f32_k1_wide_matches_plain_and_pallas(t, d):
    """The emulated kernel against the plain version and the Pallas kernel
    on the same inputs."""
    q, k, v = _inputs(t, d, seed=5 * t + d)
    got = emulate_k1_wide(q, k, v)
    assert got.dtype == torch.float32 and got.shape == (1, t, 2, d)
    assert rel_err(to_np(got), to_np(tattn.reference_attention(q, k, v))) < F32_TOL
    assert rel_err(to_np(got), _pallas(t, d)) < F32_TOL


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_f32_k1_route_covers_the_wide_heads(d):
    """f32_k1_route at D = 128/256 over every T of the gate (1-1024): the
    one-pass kernel of attention_wide.cu to T = 64 (16 query rows and keys
    to T = 16, 32 rows of 32 or 64 keys past it), then
    attention_long_f32.cuh's key-block kernel holding the whole row: K4's
    <128, 64, 512> at D = 128 up to T = 512, 32 rows of 1024 keys past it
    and at every T at D = 256. Each instance fits one CTA's shared memory
    (the byte counts attention_long_f32.cuh's header states), and the
    layouts it rules out would not: 64 query rows of 1024 keys, or D = 256
    with 64-key stages or 64 rows of 512 keys."""
    for t in range(1, 1025):
        name, rows, keys = tattn.f32_k1_route(t, d)
        if t <= 64:
            want = (16, 16) if t <= 16 else (32, 32) if t <= 32 else (32, 64)
            assert (name, rows, keys) == ("attn_short_f32_kernel",) + want, t
        else:
            want = (64, 512) if d == 128 and t <= 512 else (32, 1024)
            assert (name, rows, keys) == ("flash_f32_kernel",) + want, t
        assert t <= keys
    for bq, kcap in ((64, 512), (32, 1024)):
        assert _flash_bytes(128, bq, kcap) <= SMEM
    assert flash_stage_keys(128, 32) == 64 and flash_stage_keys(256, 32) == 32
    assert _flash_bytes(128, 32, 1024) == 217088 and _flash_bytes(256, 32, 1024) == 231936
    assert _flash_bytes(128, 64, 1024) > SMEM and _flash_bytes(256, 64, 512) > SMEM
    assert _flash_bytes(256, 32, 1024, ks=64) > SMEM


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adm_with_wide_heads_through_use_flash_matches_jax(dtype):
    """The origin ADM at test scale with 128-wide heads (model_channels 128,
    one head: D = 128 at 16x16 latents, T = 256, and D = 256 at T = 64),
    attention at both levels through use_flash, against JAX's on the same
    weights (both on their plain attention on the CPU)."""
    jm, params, tm = _pair(dict(model_channels=128, num_heads=1, use_flash=True), dtype=dtype)
    blocks = [m for m in tm.modules() if isinstance(m, ADMAttentionBlock)]
    assert {(b.qkv.out_channels // 3 // b.num_heads, b.use_flash) for b in blocks} \
        == {(128, True), (256, True)}
    got, want = _forward_both(jm, params, tm)
    assert got.shape == (2, 16, 16, 4)
    assert rel_err(got, want) < (1e-4 if dtype == "float32" else 5e-2)
