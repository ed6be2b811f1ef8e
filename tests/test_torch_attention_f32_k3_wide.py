"""f32 K3 at the origin ADM's wide heads (D = 128/256) on the CPU: the port's
plain ``attention_small_bwd`` against lfm_tpu's Pallas
``attention_small_bwd`` in interpret mode (as tests/test_kernels.py runs
it), the algorithm of its CUDA kernels (``csrc/attention_bwd_wide_f32.cu``)
written out in torch at their rounding points and in their sum orders, one
emulation a route, against both, the route mirror ``f32_k3_route`` with each
kernel's shared-memory layout over every T of the gate, and the gradient
of a test-scale origin ADM with 128-wide heads through ``use_flash`` (K1
and K3's plain versions on the CPU) against JAX's through its
``fused_attention``. The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).

The emulations follow the kernels (the header of the .cu states them): s
and dp summed over D in S slices (S = 2 at D = 128, 4 at 256; slice sl
takes the float4 blocks sl, sl + S, ... in order) added as p0 + p1 or (p0
+ p2) + (p1 + p3); the row max of the unscaled s, scaled once; e = exp(scale
s - m) as one rounding (an FMA); l (and, in the one-pass kernel, delta)
summed by the G threads of a row over their keys sub + G x in order, then
a butterfly; the two-kernel route's delta summed by key group (keys kg +
KGN x in order) and the groups added in order; p = e / l; ds = p (dp -
delta); dq = scale (ds k), dk = scale (ds^T q), dv = p^T do, each one
chain in order with the scale applied after the sum (where the dq kernel
takes 16 query rows, dq is one chain a group of keys, the groups added in
order). An FMA is emulated by
a float64 product and sum rounded once to float32 (the f32 product is
exact in float64); torch's exp is not the card's expf, so the emulation
is the kernel's order, not its bits.

Tolerances: 1e-5 of the largest reference value of each output (the same
f32 arithmetic, f32 sums in another order); the ADM's f32 gradients 1e-4
of the largest value of each tensor (tests/test_torch_train.py's).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found, randomize, rel_err, to_np  # noqa: E402,F401

from lfm_tpu.kernels import flash_attention as jattn  # noqa: E402
from lfm_tpu.nn import adm_unet as jadm  # noqa: E402
from lfm_tpu.ode.flow import interpolate as jinterpolate  # noqa: E402
from lfm_tpu_torch.kernels import flash_attention as tattn  # noqa: E402
from lfm_tpu_torch.nn import adm_unet as tadm  # noqa: E402
from lfm_tpu_torch.nn.convert_adm import adm_params_from_jax  # noqa: E402
from lfm_tpu_torch.train.train import fm_train_loss  # noqa: E402

F32_TOL = 1e-5
HEAD_DIMS = (128, 256)  # the origin ADM's heads
# celeb256_adm's and celeb512_adm's T, the routes' edges (the one-pass
# kernel's rows 16 / 32 / 64, its last T at D = 256, 48), ragged, past 64,
# past 256 (the dq kernel's second instance) and at D = 128 past 512 (its
# third, dq split by key)
LENGTHS = {128: (1, 16, 33, 64, 65, 100, 256, 300, 520),
           256: (1, 16, 33, 48, 49, 64, 65, 100, 256, 300)}
CASES = [(t, d) for d in HEAD_DIMS for t in LENGTHS[d]]
SMEM = 232448  # bytes of shared memory a CTA may have on the H100 (ATT_MAX_SMEM)
THREADS = 256


def _heads(t):
    return 4 if t <= 16 else 3 if t <= 64 else 2


def _inputs(t, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, t, _heads(t), d)).astype(np.float32))
            for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _pallas(t, d):
    """JAX's attention_small_bwd on the Pallas kernel in interpret mode."""
    q, k, v, do = (jnp.asarray(to_np(a)) for a in _inputs(t, d, seed=7 * t + d))
    with pltpu.force_tpu_interpret_mode():
        return tuple(np.asarray(g) for g in jattn.attention_small_bwd(q, k, v, do))


# ------------------------------------------------------------- the layouts

def _split(d):
    """(S, LD): slices of D a score tile sums over, the row stride (floats)
    of q, k, v and do in shared memory (Split<DP>)."""
    s = 2 if d <= 128 else 4
    return s, d + 4 * s


def _score_ld(tk, g):
    return tk + g * (2 if (tk // g) % 2 else 1)


def layout(t, d):
    """The kernels' constants at (t, d), mirrored from the .cu (Short<DP,
    TK>, WideDq<DP, BQ, TK>, WideDkdv<DP>), with each kernel's shared
    memory in bytes."""
    s, ld = _split(d)
    if t <= (64 if d == 128 else 48):
        tk = 16 if t <= 16 else 32 if t <= 32 else 64 if d == 128 else 48
        g = THREADS // (16 if tk <= 16 else 32 if tk <= 32 else 64)
        lds = _score_ld(tk, g)
        return {"route": "short", "tk": tk, "g": g, "s": s,
                "bytes": {"attn_wide_bwd_short_kernel": 4 * (4 * tk * ld + 2 * tk * lds)}}
    bq, tk = ((64, 256) if t <= 256 else (32, 512) if t <= 512 else (16, 1024)) if d == 128 \
        else (32, 256) if t <= 256 else (16, 1024)
    narrow = d == 128 and tk == 1024
    ks, dc = (64, 128) if tk == 256 else (256, 32) if narrow else (128, 64)
    g = THREADS // bq
    rm = 4 if narrow else 8
    rgn = bq // rm
    kgn = (THREADS // 8 // rgn) * (8 // s)
    ksq, split = (64 if d == 128 else 32), (1 if bq >= 32 else 4 if d == 128 else 2)
    slot = max(ks * (dc + 4 * s), ksq * ld)
    bk, ch = (64 if d == 128 else 32), 32
    dq = 4 * (2 * bq * ld + 2 * slot + bq * _score_ld(tk, g) + bq * kgn)
    dkdv = 4 * (2 * bk * ld + 2 * (2 * ch * ld + 3 * ch) + 2 * bk * (ch + 4))
    return {"route": "split", "bq": bq, "ks": ks, "dc": dc, "tk": tk, "g": g, "rm": rm,
            "kgn": kgn, "s": s, "ksq": ksq, "split": split, "bk": bk,
            "bytes": {"attn_wide_bwd_dq_kernel": dq, "attn_wide_bwd_dkdv_kernel": dkdv}}


# ------------------------------------------------------------ the emulation

def _fma(a, b, c):
    """fmaf(a, b, c) up to float64's rounding of the exact sum."""
    return (a.double() * b.double() + c.double()).float()


def _split_dot(a, b, s):
    """a (..., R, D) . b (..., C, D) -> (..., R, C): the S slices' chains,
    then (p0 + p2) + (p1 + p3) or p0 + p1."""
    parts = []
    for sl in range(s):
        acc = torch.zeros(a.shape[:-1] + (b.shape[-2],))
        for blk in range(sl, a.shape[-1] // 4, s):
            for d in range(4 * blk, 4 * blk + 4):
                acc = _fma(a[..., :, None, d], b[..., None, :, d], acc)
        parts.append(acc)
    return parts[0] + parts[1] if s == 2 else (parts[0] + parts[2]) + (parts[1] + parts[3])


def _chain_nn(a, b):
    """a (..., R, K) @ b (..., K, C) as one FMA chain over k in order."""
    acc = torch.zeros(a.shape[:-1] + (b.shape[-1],))
    for kk in range(a.shape[-1]):
        acc = _fma(a[..., :, kk, None], b[..., None, kk, :], acc)
    return acc


def _row_sum(x, g, fma_with=None):
    """Over the last axis (padded to a multiple of g with zeros): thread sub
    sums keys sub + g j in order (an FMA with ``fma_with`` where given),
    then the g partials in a butterfly (xor 1, 2, ...: adjacent pairs)."""
    keys = x.shape[-1]
    pad = -keys % g
    x = torch.nn.functional.pad(x, (0, pad))
    y = None if fma_with is None else torch.nn.functional.pad(fma_with, (0, pad))
    parts = []
    for sub in range(g):
        acc = torch.zeros(x.shape[:-1])
        for c in range(sub, keys + pad, g):
            acc = acc + x[..., c] if y is None else _fma(x[..., c], y[..., c], acc)
        parts.append(acc)
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0][..., None]


def emulate_k3_wide(q, k, v, do):
    """f32 K3 at D = 128/256 at the rounding points and in the sum orders of
    the route that f32_k3_route names: attn_wide_bwd_short_kernel, or the
    dq and dk/dv kernels (whose recomputed p and ds are the dq kernel's)."""
    n, t, h, d = q.shape
    lay = layout(t, d)
    scale = np.float32(1.0 / np.sqrt(np.float32(d)))
    qh, kh, vh, doh = (a.transpose(1, 2) for a in (q, k, v, do))  # (N, H, T, D)
    s = _split_dot(qh, kh, lay["s"])
    dp = _split_dot(doh, vh, lay["s"])
    m = (float(scale) * s.amax(dim=-1, keepdim=True)).float()
    e = torch.exp(_fma(torch.full_like(s, float(scale)), s, -m))
    l = _row_sum(e, lay["g"])
    p = e / l
    if lay["route"] == "short":
        delta = _row_sum(p, lay["g"], fma_with=dp)
    else:  # by key group, the groups in order
        kgn = lay["kgn"]
        parts = [_row_sum(p[..., kg::kgn], 1, fma_with=dp[..., kg::kgn]) for kg in range(kgn)
                 if kg < t]
        delta = parts[0]
        for part in parts[1:]:
            delta = delta + part
    ds = p * (dp - delta)
    if lay["route"] == "short" or lay["split"] == 1:
        dq = _chain_nn(ds, kh)
    else:  # a chain a group of keys (KSQ / SPLIT of every KSQ), added in order
        ksq, split = lay["ksq"], lay["split"]
        group = (torch.arange(t) % ksq) // (ksq // split)
        dq = None
        for grp in range(split):
            keys = (group == grp).nonzero().flatten()
            part = _chain_nn(ds[..., keys], kh[..., keys, :])
            dq = part if dq is None else dq + part
    dq = float(scale) * dq
    dk = float(scale) * _chain_nn(ds.transpose(-1, -2), qh)
    dv = _chain_nn(p.transpose(-1, -2), doh)
    return tuple(a.transpose(1, 2) for a in (dq, dk, dv))


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("t,d", CASES)
def test_plain_k3_matches_the_pallas_kernel(t, d):
    """reference_attention_bwd, the port's plain K3 and what a CPU tensor
    runs, against JAX's attention_small_bwd at the ADM's heads."""
    q, k, v, do = _inputs(t, d, seed=7 * t + d)
    got = tattn.attention_small_bwd(q, k, v, do)
    for g, w in zip(got, _pallas(t, d)):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert rel_err(g, w) < F32_TOL


@pytest.mark.parametrize("t,d", CASES)
def test_kernel_emulation_matches_pallas_and_plain(t, d):
    q, k, v, do = _inputs(t, d, seed=7 * t + d)
    emu = emulate_k3_wide(q, k, v, do)
    for g, w, p in zip(emu, _pallas(t, d), tattn.reference_attention_bwd(q, k, v, do)):
        assert rel_err(g, w) < F32_TOL and rel_err(g, p) < F32_TOL


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_route_and_shared_memory_over_the_gate(d):
    """At every T of the gate f32_k3_route names the kernels that the .cu's
    dispatch launches: the one-pass kernel through T = 64 (48 at D = 256),
    the dq and dk/dv kernels past it; every kernel's layout fits a CTA, and
    its score and output tiles cover its rows, keys and columns exactly."""
    s, _ = _split(d)
    for t in range(1, 1025):
        names, rows, keys = tattn.f32_k3_route(t, d)
        lay = layout(t, d)
        assert tuple(lay["bytes"]) == names, (t, d)
        assert all(b <= SMEM for b in lay["bytes"].values()), (t, d, lay["bytes"])
        if lay["route"] == "short":
            tk = lay["tk"]
            assert rows == keys == tk >= t and tk % 16 == 0
            rm = s if tk == 16 else 4 if tk == 32 else 8 if d == 128 else 12
            rgn = tk // rm
            kgn = (THREADS // 2 // 8 // rgn) * (8 // s)
            assert rgn * rm == tk and tk % kgn == 0 and rm % s == 0
            assert THREADS // (d // 4) * (tk // (THREADS // (d // 4))) == tk
        else:
            assert (rows, keys) == (lay["bq"], lay["bk"]) and lay["tk"] >= t
            assert lay["ks"] % lay["kgn"] == 0 and lay["tk"] % lay["ks"] == 0
            assert lay["rm"] % s == 0 and (lay["dc"] // 4) % s == 0 and d % lay["dc"] == 0
            # dq: each group's threads cover the BQ x D output in RMO x 4 tiles
            gt = THREADS // lay["split"]
            assert lay["bq"] % (gt // (d // 4)) == 0 and lay["ksq"] % (4 * lay["split"]) == 0
    big = {128: (174080, 209920, 167936, 158464), 256: (228864, 179200, 185344, 218880)}[d]
    got = (layout(64 if d == 128 else 48, d)["bytes"]["attn_wide_bwd_short_kernel"],
           layout(256, d)["bytes"]["attn_wide_bwd_dq_kernel"],
           layout(1024, d)["bytes"]["attn_wide_bwd_dq_kernel"],
           layout(1024, d)["bytes"]["attn_wide_bwd_dkdv_kernel"])
    assert got == big
    assert layout(16, 128)["bytes"]["attn_wide_bwd_short_kernel"] == 40960
    assert tattn.f32_k3_route(256, 64)[0] == ("attn_row_bwd_dq_kernel",
                                              "attn_row_bwd_dkdv_kernel")
    assert tattn.f32_k3_route(257, 72)[0] == ("attn_long_bwd_dq_kernel",
                                              "attn_row_bwd_dkdv_kernel")
    assert tattn.F32_HEAD_DIMS["attention_small_bwd"] == (128, 256)


def test_adm_gradients_through_fused_attention_match_jax():
    """A test-scale origin ADM with 128-wide heads (C = 256, 2 heads) whose
    attention runs use_flash: its f32 loss and parameter gradients on the
    CPU (K1's and K3's plain versions through the port's autograd
    Function) against JAX's through its fused_attention custom_vjp."""
    kw = dict(image_size=8, in_channels=4, model_channels=128, out_channels=4,
              num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2,
              use_flash=True)
    jm = jadm.UNetModel(**kw)
    rng = np.random.default_rng(11)
    z0, z1 = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    t = rng.uniform(size=(2,)).astype(np.float32)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(t), jnp.asarray(z0)), 5,
                       scale=0.1)
    tm = tadm.UNetModel(**kw)
    tm.load_state_dict(adm_params_from_jax(params, tm.plan))

    def loss(p):
        z_t, u = jinterpolate(jnp.asarray(z0), jnp.asarray(z1), jnp.asarray(t))
        return jnp.mean(jnp.square(jm.apply(p, jnp.asarray(t), z_t, train=True) - u))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    tloss = fm_train_loss(tm, torch.from_numpy(z0), None, torch.from_numpy(t),
                          torch.from_numpy(z1))
    tloss.backward()
    want = adm_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), tm.plan)
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    attn = [name for name in want if ".qkv." in name]
    assert attn and all(float(want[name].abs().max()) > 0 for name in attn)
    for name, p in tm.named_parameters():
        assert rel_err(to_np(p.grad), want[name].numpy()) < 1e-4, name
