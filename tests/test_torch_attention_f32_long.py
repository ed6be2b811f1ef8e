"""The algorithms of the port's f32 K4 and f32 K3 past T = 256
(``csrc/attention_long_f32.cuh``, with the dk/dv kernel of
``csrc/attention_row_f32.cuh``), written out in torch as the kernels run
them, against lfm_tpu's Pallas ``flash_attention`` and
``attention_small_bwd`` in interpret mode on the CPU and against the port's
plain versions. The kernels themselves run only on the card
(tests/test_torch_cuda.py); these tests hold their arithmetic: K4's key
blocks (ragged ones included, ending inside a ring stage), the exact max of
each block, the order of its l sums and the blocking of its p v sums (two groups each
taking half of every stage at D <= 64, a fresh partial per stage otherwise);
K3's whole row of scores, the order of its l and delta sums, dq summed per
stage (two groups at D <= 64) and dk, dv per 64-query chunk.

Tolerance: 1e-5 of the largest reference value (the same f32 arithmetic,
f32 sums in another order). The products here are torch's f32 matmuls:
where a kernel runs one FMA chain, they emulate its blocking (which keys go
into one sum), not the order within the chain. The l and delta sums
follow the kernels' order (key_group_sum, checked bit for bit below).
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
CHUNK = 64  # queries of a dk/dv stage


def _inputs(shape, count, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(count)]


def key_group_sum(x: torch.Tensor, tc: int) -> torch.Tensor:
    """Sum over the last axis in the kernels' order: key group g of tc sums
    keys g + tc j for j in order; the 4 groups of a warp (g = 4 w + r) add
    as a tree, (r0 + r1) + (r2 + r3) (shuffles xor 8, 16); the tc / 4 warps'
    partials in order."""
    width = x.shape[-1]
    cols = x.reshape(*x.shape[:-1], width // tc, tc)
    part = cols[..., 0, :]
    for j in range(1, width // tc):
        part = part + cols[..., j, :]
    quads = part.reshape(*x.shape[:-1], tc // 4, 4)
    warps = (quads[..., 0] + quads[..., 1]) + (quads[..., 2] + quads[..., 3])
    total = warps[..., 0]
    for w in range(1, tc // 4):
        total = total + warps[..., w]
    return total


def _heads(*tensors):
    """(N, T, H, D) -> (N, H, T, D)."""
    return [a.transpose(1, 2) for a in tensors]


def _pad_keys(a: torch.Tensor, width: int, dim: int) -> torch.Tensor:
    """Zero-pad axis `dim` (-1 or -2) to `width`, as the ring's stages past
    the block or T."""
    pad = width - a.shape[dim]
    return torch.nn.functional.pad(a, (0, pad) if dim == -1 else (0, 0, 0, pad))


def flash_layout(d: int):
    """K4's padded head dim, keys of a ring stage and key groups of a score
    row (FlashLayout): DP 64 -> 128 keys, 16 groups; 80 -> 64, 16; 128 ->
    32, 8."""
    dp = 64 if d <= 64 else 80 if d <= 80 else 128
    ks = {64: 128, 80: 64, 128: 32}[dp]
    return dp, ks, ks // (8 if dp == 64 else 4)


def emulate_k4(q, k, v, block_k):
    """f32 K4 as attention_long_f32.cuh's flash_f32_kernel computes it: per
    block of bk = _pick_block(T, block_k) keys (in stages of KS keys, zero
    past the block), s = q k^T, the block max m_b = scale max s (taken
    unscaled, scaled once), m_new = max(m, m_b), p = exp(scale s - m_new),
    alpha = exp(m - m_new), l = alpha l + sum p (the kernels' order), acc =
    alpha acc + pv; at DP 64 two groups each sum the p v of their half of
    every stage of the block in one chain (here one product over those
    keys) and keep their own acc, added at the end; otherwise each stage's
    p v is a fresh partial added to the block's. o = acc / l."""
    n, t, h, d = q.shape
    bk = tattn._pick_block(t, block_k)
    dp, ks, tc = flash_layout(d)
    width = -(-bk // ks) * ks
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = _heads(q, k, v)
    m = torch.full((n, h, t), -math.inf)
    l = torch.zeros(n, h, t)
    groups = 2 if dp == 64 else 1
    acc = [torch.zeros(n, h, t, d) for _ in range(groups)]
    for b0 in range(0, t, bk):
        s = qf @ kf[:, :, b0:b0 + bk].transpose(-1, -2)
        m_new = torch.maximum(m, scale * s.amax(dim=-1))
        p = _pad_keys(torch.exp(scale * s - m_new[..., None]), width, -1)
        vb = _pad_keys(vf[:, :, b0:b0 + bk], width, -2)
        alpha = torch.exp(m - m_new)
        l = alpha * l + key_group_sum(p, tc)
        if groups == 2:  # group g's half of every stage, one product
            halves = [torch.arange(c0, c0 + ks // 2) for c0 in range(0, width, ks)]
            pvs = [p[..., idx] @ vb[:, :, idx]
                   for idx in (torch.cat(halves), torch.cat(halves) + ks // 2)]
        else:  # a fresh partial per stage
            pvs = [torch.zeros(n, h, t, d)]
            for c0 in range(0, width, ks):
                pvs[0] = pvs[0] + p[..., c0:c0 + ks] @ vb[:, :, c0:c0 + ks]
        for g in range(groups):
            acc[g] = alpha[..., None] * acc[g] + pvs[g]
        m = m_new
    return (sum(acc[1:], acc[0]) / l[..., None]).transpose(1, 2)


def emulate_k3_long(q, k, v, do):
    """f32 K3 past T = 256 as its two kernels compute it.

    attn_long_bwd_dq_kernel, per query row over the whole row of keys (in
    stages of KS = 128 keys at DP 64, 64 at DP 80; zero past T): s = q k^T,
    m = scale max s, e = exp(scale s - m), l = sum e, p = e / l, dp = do v^T,
    delta = sum p dp (l and delta in the kernels' order over 16 key groups),
    ds = p (dp - delta); dq = scale ds k, each stage's keys (each half of a
    stage, for two groups, at DP 64) a fresh partial added to the total.
    attn_row_bwd_dkdv_kernel (attention_row_f32.cuh), per key over 64-query
    chunks: the same p and ds (it forms them from the same s, m and l), dv =
    sum p^T do and dk = scale sum ds^T q, each chunk a fresh partial added
    to the total."""
    n, t, h, d = q.shape
    ks = 128 if d <= 64 else 64
    groups = 2 if d <= 64 else 1
    width = -(-t // ks) * ks
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = _heads(q, k, v, do)
    s = qf @ kf.transpose(-1, -2)
    m = scale * s.amax(dim=-1)
    e = _pad_keys(torch.exp(scale * s - m[..., None]), width, -1)
    l = key_group_sum(e, 16)
    p = e / l[..., None]
    dpm = _pad_keys(dof @ vf.transpose(-1, -2), width, -1)
    delta = key_group_sum(p * dpm, 16)
    ds = p * (dpm - delta[..., None])
    kp = _pad_keys(kf, width, -2)
    totals = []
    for g in range(groups):
        total = torch.zeros(n, h, t, d)
        for c0 in range(g * ks // groups, width, ks):
            c1 = c0 + ks // groups
            total = total + ds[..., c0:c1] @ kp[:, :, c0:c1]
        totals.append(total)
    dq = scale * sum(totals[1:], totals[0])
    p, ds = p[..., :t], ds[..., :t]
    dk = torch.zeros(n, h, t, d)
    dv = torch.zeros(n, h, t, d)
    for c0 in range(0, t, CHUNK):
        rows = slice(c0, c0 + CHUNK)
        dv = dv + p[:, :, rows].transpose(-1, -2) @ dof[:, :, rows]
        dk = dk + ds[:, :, rows].transpose(-1, -2) @ qf[:, :, rows]
    return tuple(g.transpose(1, 2) for g in (dq, scale * dk, dv))


@pytest.mark.parametrize("d", (64, 80, 128))
@pytest.mark.parametrize("block_k", (256, 512))
@pytest.mark.parametrize("t", (1030, 2048))
def test_f32_k4_kernel_matches_pallas_kernel(t, block_k, d):
    """The emulated f32 K4 against the Pallas kernel and the port's plain
    version at N = 1, H = 2: T past the small-T gate, ragged (1030 = 5 x
    206: blocks that end inside a stage of 32, 64 or 128 keys) and 2048 in
    blocks of 256 and 512, every padded head dim."""
    q, k, v = _inputs((1, t, 2, d), 3, seed=t + block_k + d)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_attention(*(jnp.asarray(to_np(a)) for a in (q, k, v)),
                                     block_k=block_k)
    got = emulate_k4(q, k, v, block_k)
    assert got.dtype == torch.float32 and got.shape == (1, t, 2, d)
    assert rel_err(to_np(got), np.asarray(want)) < F32_TOL
    plain = tattn.reference_flash_attention(q, k, v, block_k=block_k)
    assert rel_err(to_np(got), to_np(plain)) < F32_TOL


@pytest.mark.parametrize("d", (64, 80))
@pytest.mark.parametrize("t", (257, 300, 512, 1024))
def test_f32_k3_long_kernels_match_pallas_kernel(t, d):
    """The emulated f32 K3 past T = 256 against the Pallas kernel and the
    port's plain version at N = 2, H = 2: T just past the row kernels' 256,
    ragged (300: a partial stage and chunk), 512 (the TK 512 build's edge)
    and 1024 (the gate), at both padded head dims."""
    q, k, v, do = _inputs((2, t, 2, d), 4, seed=13 * t + d)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.attention_small_bwd(*(jnp.asarray(to_np(a)) for a in (q, k, v, do)))
    got = emulate_k3_long(q, k, v, do)
    plain = tattn.reference_attention_bwd(q, k, v, do)
    for name, g, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        assert g.dtype == torch.float32 and g.shape == (2, t, 2, d)
        assert rel_err(to_np(g), np.asarray(w)) < F32_TOL, name
        assert rel_err(to_np(g), to_np(p)) < F32_TOL, name


def test_key_group_sum_is_the_kernels_tree():
    """key_group_sum bit for bit against the order it names, step by step in
    numpy f32 on values whose sum depends on the order, for the 16 key
    groups of K3 and K4 at DP 64 and 80 and the 8 of DP 128."""
    rng = np.random.default_rng(5)
    for tc in (16, 8):
        x = (rng.standard_normal(4 * tc * 3) * 10.0 ** rng.integers(-4, 5, 4 * tc * 3)).astype(
            np.float32)
        groups = []
        for g in range(tc):
            acc = np.float32(0.0)
            for val in x[g::tc]:
                acc = np.float32(acc + val)
            groups.append(acc)
        total = None
        for w in range(tc // 4):
            r = groups[4 * w:4 * w + 4]
            part = np.float32(np.float32(r[0] + r[1]) + np.float32(r[2] + r[3]))
            total = part if total is None else np.float32(total + part)
        got = key_group_sum(torch.from_numpy(x).reshape(1, -1), tc)[0]
        assert got.numpy().tobytes() == np.float32(total).tobytes()
