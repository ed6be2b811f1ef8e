"""The algorithms of the port's f32 K1 and K3 at the DiT's heads
(``csrc/attention_row_f32.cuh``: T <= 256, D 56-80 padded to 64 or 80),
written out in torch as the kernels run them, against lfm_tpu's Pallas
``attention_small`` and ``attention_small_bwd`` in interpret mode on the CPU
and against the port's plain versions. The kernels themselves run only on
the card (tests/test_torch_cuda.py); these tests hold their arithmetic: the
64-row tiles, the whole key row of a tile at once (the exact row max, no
online rescaling), the masks past T, the order in which l and delta are
summed, the statistics K3's second kernel reads, and its 64-query chunks.

Tolerance: 1e-5 of the largest reference value (the same f32 arithmetic,
f32 sums in another order; the products here are torch's f32 matmuls, the
kernel's are FMA chains in the order of D or of the keys).
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tests.torch_parity import leaves_process_as_found, rel_err, to_np  # noqa: E402,F401

from lfm_tpu.kernels import flash_attention as jattn  # noqa: E402
from lfm_tpu_torch.kernels import flash_attention as tattn  # noqa: E402

F32_TOL = 1e-5
BQ = 64  # query rows of a K1 / dq tile, keys of a dk/dv tile, queries of a chunk
HEAD_DIMS = (56, 64, 72, 80)
LENGTHS = (1, 64, 100, 256)


def _inputs(shape, count, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(count)]


def key_tile(t: int) -> int:
    """TK: the keys a K1 / dq tile holds, T rounded up to 64, 128 or 256."""
    assert 1 <= t <= 256
    return 64 if t <= 64 else 128 if t <= 128 else 256


def padded_dim(d: int) -> int:
    return 64 if d <= 64 else 80


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (TK keys) in the kernels' order: thread tx of
    32 sums keys tx + 32 j for j in order; the 8 lanes of a row group by
    shuffle (xor 1, 2, 4); the 4 warps' partials in order."""
    tk = x.shape[-1]
    cols = x.reshape(*x.shape[:-1], tk // 32, 32)
    part = cols[..., 0, :]
    for j in range(1, tk // 32):
        part = part + cols[..., j, :]
    lanes = part.reshape(*x.shape[:-1], 4, 8)
    for _ in range(3):  # xor 1, 2, 4
        lanes = lanes[..., 0::2] + lanes[..., 1::2]
    warps = lanes[..., 0]
    return ((warps[..., 0] + warps[..., 1]) + warps[..., 2]) + warps[..., 3]


def _heads(*tensors, dp):
    """(N, T, H, D) -> (N, H, T, DP), zero-padded as the kernels' tiles."""
    d = tensors[0].shape[-1]
    return [torch.nn.functional.pad(a.transpose(1, 2), (0, dp - d)) for a in tensors]


def emulate_k1(q, k, v):
    """f32 K1 as attention_row_f32.cuh's attn_row_kernel computes it: per
    64-row query tile, all TK keys at once (keys past T masked to -inf):
    s = scale q k^T, the exact row max m, e = exp(s - m), l summed in the
    kernel's order, o = (e v) * (1 / l), e v at D <= 64 summed over two
    halves of the keys (T rounded up to 4, halved in whole 4-key steps)
    and the halves added."""
    n, t, h, d = q.shape
    tk, dp = key_tile(t), padded_dim(d)
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = _heads(q, k, v, dp=dp)
    kf, vf = (torch.nn.functional.pad(a, (0, 0, 0, tk - t)) for a in (kf, vf))
    klen = min(tk, -(-t // 4) * 4)
    kh = (klen // 8) * 4 if dp == 64 else klen
    out = torch.empty(n, h, t, dp)
    for q0 in range(0, t, BQ):
        s = scale * (qf[:, :, q0:q0 + BQ] @ kf.transpose(-1, -2))
        s[..., t:] = -math.inf
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        ev = e[..., :kh] @ vf[:, :, :kh] + e[..., kh:klen] @ vf[:, :, kh:klen]
        out[:, :, q0:q0 + BQ] = ev * (1.0 / row_sum(e))[..., None]
    return out[..., :d].transpose(1, 2)


def emulate_k3(q, k, v, do):
    """f32 K3 as attention_row_f32.cuh's two kernels compute it.

    attn_row_bwd_dq_kernel, per 64-row query tile over all TK keys: s =
    scale q k^T (masked past T), m, e = exp(s - m), dp = do v^T, l in the
    kernel's order, p = e / l, delta = sum p dp in the kernel's order, ds =
    p (dp - delta), dq = scale ds k; it writes m, l and delta.
    attn_row_bwd_dkdv_kernel, per tile of keys (128 at D <= 64, else 64: a
    key's dk and dv do not depend on the others), over 64-query chunks in
    order: s^T = k q^T, p^T = exp(scale s^T - m) / l, dp^T = v do^T, ds^T =
    p^T (dp^T - delta), dv += p^T do, dk += ds^T q; dk = scale dk. Both
    kernels sum q k and do v over D in the same order (one FMA chain,
    operands commuted) and form exp(scale s - m) the same way, so s^T, dp^T
    and p^T are s, dp and p bit for bit: the emulation takes them from one
    product."""
    n, t, h, d = q.shape
    tk, dp_ = key_tile(t), padded_dim(d)
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = _heads(q, k, v, do, dp=dp_)
    s_all = torch.full((n, h, t, tk), -math.inf)
    s_all[..., :t] = scale * (qf @ kf.transpose(-1, -2))
    dp_all = torch.zeros(n, h, t, tk)
    dp_all[..., :t] = dof @ vf.transpose(-1, -2)
    kp = torch.nn.functional.pad(kf, (0, 0, 0, tk - t))
    m = torch.empty(n, h, t)
    l = torch.empty(n, h, t)
    delta = torch.empty(n, h, t)
    dq = torch.empty(n, h, t, dp_)
    for q0 in range(0, t, BQ):
        rows = slice(q0, min(q0 + BQ, t))
        s, dpt = s_all[:, :, rows], dp_all[:, :, rows]
        mt = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - mt)
        lt = row_sum(e)[..., None]
        p = e / lt
        dt = row_sum(p * dpt)[..., None]
        ds = p * (dpt - dt)
        dq[:, :, rows] = scale * (ds @ kp)
        m[:, :, rows], l[:, :, rows], delta[:, :, rows] = mt[..., 0], lt[..., 0], dt[..., 0]

    dk = torch.zeros(n, h, t, dp_)
    dv = torch.zeros(n, h, t, dp_)
    for c0 in range(0, t, BQ):
        cols = slice(c0, min(c0 + BQ, t))
        st = s_all[:, :, cols, :t].transpose(-1, -2)  # keys x queries
        pt = torch.exp(st - m[:, :, None, cols]) / l[:, :, None, cols]
        dpt = dp_all[:, :, cols, :t].transpose(-1, -2)
        dst = pt * (dpt - delta[:, :, None, cols])
        dv = dv + pt @ dof[:, :, cols]
        dk = dk + dst @ qf[:, :, cols]
    return tuple(g[..., :d].transpose(1, 2) for g in (dq, scale * dk, dv))


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("t", LENGTHS)
def test_f32_k1_row_kernel_matches_pallas_kernel(t, d):
    """The emulated f32 K1 against the Pallas kernel and the port's plain
    version at N = 2, H = 2: every head dim the kernel takes, T at the
    key-tile sizes (64, 256: the edge of the dispatch), ragged (100) and 1."""
    q, k, v = _inputs((2, t, 2, d), 3, seed=7 * t + d)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.attention_small(*(jnp.asarray(to_np(a)) for a in (q, k, v)))
    got = emulate_k1(q, k, v)
    assert got.dtype == torch.float32 and got.shape == (2, t, 2, d)
    assert rel_err(to_np(got), np.asarray(want)) < F32_TOL
    assert rel_err(to_np(got), to_np(tattn.reference_attention(q, k, v))) < F32_TOL


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("t", LENGTHS)
def test_f32_k3_row_kernels_match_pallas_kernel(t, d):
    """The emulated f32 K3 (whole-row statistics in the dq kernel, 64-query
    chunks in the dk/dv kernel) against the Pallas kernel and the port's
    plain version, at the shapes of the K1 test."""
    q, k, v, do = _inputs((2, t, 2, d), 4, seed=11 * t + d)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.attention_small_bwd(*(jnp.asarray(to_np(a)) for a in (q, k, v, do)))
    got = emulate_k3(q, k, v, do)
    plain = tattn.reference_attention_bwd(q, k, v, do)
    for name, g, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        assert g.dtype == torch.float32 and g.shape == (2, t, 2, d)
        assert rel_err(to_np(g), np.asarray(w)) < F32_TOL, name
        assert rel_err(to_np(g), to_np(p)) < F32_TOL, name
