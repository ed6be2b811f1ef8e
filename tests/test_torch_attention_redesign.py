"""The blocked algorithms of the port's bf16 K3 (``csrc/attention_bwd_sm90.cuh``)
and of its f32 K1 at short T (``csrc/attention_wide.cu``), written out in
torch as the kernels run them, against lfm_tpu's Pallas ``attention_small_bwd``
and ``attention_small`` in interpret mode on the CPU (as
tests/test_torch_attention_bwd.py runs them). The kernels themselves run only
on the card (tests/test_torch_cuda.py); these tests hold their arithmetic:
tile sizes, online statistics, rounding points.

Tolerances: bf16 2e-2 of the largest reference value (p and ds round to bf16
on both sides, and a rounding that falls the other way moves a term by
2^-8); f32 1e-5 (the same arithmetic, f32 sums in another order).
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

BF16_TOL = 2e-2
F32_TOL = 1e-5
TILE = 64  # K3's key and query tiles
LOG2E = 1.4426950408889634


def _inputs(shape, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(count)]


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float()


def emulate_k3(q, k, v, do):
    """bf16 K3 as attention_bwd_sm90.cuh computes it, on (N, T, H, D) bf16
    tensors; returns (dq, dk, dv) in bf16.

    Kernel 1, pass 1: 64-key tiles, each row's max m, l = sum e and sum e dp
    online (rescaled by exp2((m - m_new) scale log2 e) when m grows), then
    lse = m scale log2 e + log2 l and delta = sum e dp / l. Pass 2: p =
    exp2(s scale log2 e - lse), ds = p (dp - delta) rounded to bf16, dq += ds
    K per key tile. Kernel 2: per 64-query tile, p^T and ds^T from the same
    lse and delta, dv += bf16(p)^T dO and dk += ds^T Q."""
    n, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    c = scale * LOG2E
    qf, kf, vf, dof = (a.float().transpose(1, 2) for a in (q, k, v, do))  # (N, H, T, D)
    tiles = [slice(t0, min(t0 + TILE, t)) for t0 in range(0, t, TILE)]

    m = torch.full((n, h, t, 1), -math.inf)
    l = torch.zeros((n, h, t, 1))
    pd = torch.zeros((n, h, t, 1))
    for kt in tiles:
        s = qf @ kf[:, :, kt].transpose(-1, -2)
        dp = dof @ vf[:, :, kt].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c)
        e = torch.exp2(s * c - m_new * c)
        l = l * corr + e.sum(dim=-1, keepdim=True)
        pd = pd * corr + (e * dp).sum(dim=-1, keepdim=True)
        m = m_new
    delta = pd / l
    lse = m * c + torch.log2(l)

    dq = torch.zeros_like(qf)
    for kt in tiles:
        s = qf @ kf[:, :, kt].transpose(-1, -2)
        dp = dof @ vf[:, :, kt].transpose(-1, -2)
        p = torch.exp2(s * c - lse)
        dq = dq + _bf16(p * (dp - delta)) @ kf[:, :, kt]

    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for qt in tiles:
        st = kf @ qf[:, :, qt].transpose(-1, -2)  # keys x queries
        dpt = vf @ dof[:, :, qt].transpose(-1, -2)
        pt = torch.exp2(st * c - lse[:, :, qt].transpose(-1, -2))
        dst = pt * (dpt - delta[:, :, qt].transpose(-1, -2))
        dv = dv + _bf16(pt) @ dof[:, :, qt]
        dk = dk + _bf16(dst) @ qf[:, :, qt]
    return tuple((g.transpose(1, 2)).to(torch.bfloat16) for g in (scale * dq, scale * dk, dv))


def short_query_rows(t: int) -> int:
    """The f32 one-pass kernel's query tile: 16 rows for T <= 16, else 32."""
    return 16 if t <= 16 else 32


def emulate_k1_short(q, k, v):
    """f32 K1 at T <= 64 as attention_wide.cu computes it: per tile of
    ``short_query_rows(T)`` query rows, one pass over all T keys: s = scale q
    k^T, the exact row max, p = exp(s - m), l = sum p, o = (p v) / l."""
    n, t, h, d = q.shape
    assert t <= 64
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = (a.transpose(1, 2) for a in (q, k, v))
    out = torch.empty_like(qf)
    bq = short_query_rows(t)
    for q0 in range(0, t, bq):
        s = scale * (qf[:, :, q0:q0 + bq] @ kf.transpose(-1, -2))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        out[:, :, q0:q0 + bq] = (p @ vf) / p.sum(dim=-1, keepdim=True)
    return out.transpose(1, 2)


@pytest.mark.parametrize("d", [56, 64, 72, 80])
@pytest.mark.parametrize("t", [100, 256, 1024])
def test_k3_blocked_algorithm_matches_pallas_kernel(t, d):
    """The emulated bf16 K3 against the Pallas kernel (and the port's plain
    version) at N = 2, H = 2, every head dim the kernel takes, ragged T."""
    q, k, v, do = (_bf16(torch.from_numpy(a)) for a in _inputs((2, t, 2, d), 4, seed=t + d))
    with pltpu.force_tpu_interpret_mode():
        want = jattn.attention_small_bwd(*(jnp.asarray(to_np(a), jnp.bfloat16)
                                           for a in (q, k, v, do)))
    bf = [a.to(torch.bfloat16) for a in (q, k, v, do)]
    got = emulate_k3(*bf)
    plain = tattn.reference_attention_bwd(*bf)
    for name, g, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        assert g.dtype == torch.bfloat16 and g.shape == (2, t, 2, d)
        assert rel_err(to_np(g), np.asarray(w, np.float32)) < BF16_TOL, name
        assert rel_err(to_np(g), to_np(p)) < BF16_TOL, name


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("t", [1, 15, 16, 17, 32, 33, 64])
def test_f32_k1_one_pass_matches_pallas_kernel(t, d):
    """The emulated f32 K1 at short T (16- and 32-row query tiles, one pass
    over the keys) against the Pallas kernel, at the tile boundaries."""
    q, k, v = (torch.from_numpy(a) for a in _inputs((2, t, 2, d), 3, seed=t * d))
    with pltpu.force_tpu_interpret_mode():
        want = jattn.attention_small(*(jnp.asarray(to_np(a)) for a in (q, k, v)))
    got = emulate_k1_short(q, k, v)
    assert got.dtype == torch.float32
    assert rel_err(to_np(got), np.asarray(want)) < F32_TOL
    assert rel_err(to_np(got), to_np(tattn.reference_attention(q, k, v))) < F32_TOL


@pytest.mark.parametrize("n,t,h", [(1, 1, 1), (2, 100, 3), (32, 256, 16), (1, 1024, 2)])
def test_k3_stats_scratch_holds_both_layouts(n, t, h):
    """The scratch the wrappers give K3 holds bf16's lse and delta for every
    row up to T rounded to 64 and f32's m, l and delta for every row."""
    tp = -(-t // TILE) * TILE
    size = tattn.bwd_stats_scratch(n, t, h, "cpu").numel()
    assert size >= 2 * n * h * tp and size >= 3 * n * h * t
