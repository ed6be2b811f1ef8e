"""f32 K3 at the origin ADM's wide heads (D = 128/256) on the CPU: the port's
plain ``attention_small_bwd`` against lfm_tpu's Pallas
``attention_small_bwd`` in interpret mode (as tests/test_kernels.py runs
it), the algorithm of its CUDA kernels (``csrc/attention_bwd_wide_f32.cu``)
written out in torch at their rounding points against both, the route
mirror ``f32_k3_route`` with the two kernels' shared-memory layouts over
every T of the gate, and the gradient of a test-scale origin ADM with
128-wide heads through ``use_flash`` (K1 and K3's plain versions on the
CPU) against JAX's through its ``fused_attention``. The kernels themselves
run only on the card (tests/test_torch_cuda.py, chip_smoke.py).

The emulation follows the kernels' rounding points: the dq kernel's row
max of the unscaled s, scaled once; e = exp(scale s - m) as one rounding
(an FMA); l = sum e; p = e / l; delta = rowsum(p dp); ds = p (dp - delta);
dq = scale (ds k), dk = scale (ds^T q), dv = p^T do with the scale applied
after the sum. Its products are torch's f32 matmuls: the kernel's sums are
single chains in order, which torch's blocked sums do not reproduce.

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
LENGTHS = (16, 64, 100, 256)  # celeb256_adm's and celeb512_adm's, ragged, past 64
HEAD_DIMS = (128, 256)  # the origin ADM's heads
HEADS = {16: 4, 64: 3, 100: 2, 256: 2}
SMEM = 232448  # bytes of shared memory a CTA may have on the H100 (ATT_MAX_SMEM)
THREADS = 256


def _inputs(t, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, t, HEADS[t], d)).astype(np.float32))
            for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _pallas(t, d):
    """JAX's attention_small_bwd on the Pallas kernel in interpret mode."""
    q, k, v, do = (jnp.asarray(to_np(a)) for a in _inputs(t, d, seed=7 * t + d))
    with pltpu.force_tpu_interpret_mode():
        return tuple(np.asarray(g) for g in jattn.attention_small_bwd(q, k, v, do))


def emulate_k3_wide(q, k, v, do):
    """f32 K3 at D = 128/256 at attn_wide_bwd_dq_kernel's and
    attn_wide_bwd_dkdv_kernel's rounding points (module docstring)."""
    n, t, h, d = q.shape
    scale = np.float32(1.0 / np.sqrt(np.float32(d)))
    qh, kh, vh, doh = (a.transpose(1, 2) for a in (q, k, v, do))  # (N, H, T, D)
    s = qh @ kh.transpose(-1, -2)
    m = (float(scale) * s.amax(dim=-1, keepdim=True)).float()
    # scale s - m with one rounding, as the kernel's FMA: the f32 product is
    # exact in float64
    e = torch.exp((float(scale) * s.double() - m.double()).float())
    p = e / e.sum(dim=-1, keepdim=True)
    dp = doh @ vh.transpose(-1, -2)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = float(scale) * (ds @ kh)
    dk = float(scale) * (ds.transpose(-1, -2) @ qh)
    dv = p.transpose(-1, -2) @ doh
    return tuple(a.transpose(1, 2) for a in (dq, dk, dv))


@pytest.mark.parametrize("t", LENGTHS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_k3_matches_the_pallas_kernel(t, d):
    """reference_attention_bwd, the port's plain K3 and what a CPU tensor
    runs, against JAX's attention_small_bwd at the ADM's heads."""
    q, k, v, do = _inputs(t, d, seed=7 * t + d)
    got = tattn.attention_small_bwd(q, k, v, do)
    for g, w in zip(got, _pallas(t, d)):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert rel_err(g, w) < F32_TOL


@pytest.mark.parametrize("t", LENGTHS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_kernel_emulation_matches_pallas_and_plain(t, d):
    q, k, v, do = _inputs(t, d, seed=7 * t + d)
    emu = emulate_k3_wide(q, k, v, do)
    for g, w, p in zip(emu, _pallas(t, d), tattn.reference_attention_bwd(q, k, v, do)):
        assert rel_err(g, w) < F32_TOL and rel_err(g, p) < F32_TOL


def _dq_bytes(t, d):
    """WideDq<DP>::bytes(T): q and do (16 rows of D + 4 floats), a ring of
    two KS-key stages, three reductions (4 warps x 16 rows), the rows of s
    and dp (16 x lds, lds = T rounded up to KS, plus 4)."""
    ks = 64 if d <= 128 else 32
    ld = d + 4
    lds = -(-t // ks) * ks + 4
    return 4 * (2 * 16 * ld + 2 * ks * ld + 3 * 4 * 16 + 2 * 16 * lds)


def _dkdv_bytes(d):
    """WideDkdv<DP>::BYTES: k and v (BK rows), two stages of a 32-query chunk
    (q, do, m, l, delta), p and ds (BK x 36)."""
    bk = 64 if d <= 128 else 32
    ld = d + 4
    return 4 * (2 * bk * ld + 2 * (2 * 32 * ld + 3 * 32) + 2 * bk * 36)


def test_route_and_shared_memory_over_the_gate():
    """f32_k3_route names the wide kernels at D 128/256 at every T of the
    gate and the row / long kernels at the DiT's heads; the dq kernel's
    layout fits a CTA at every T up to 1024 (232,192 bytes at D = 256, T =
    1024, the tightest), the dk/dv kernel's at both head dims, and each
    thread's output tiles cover the tile exactly."""
    for d in HEAD_DIMS:
        for t in range(1, 1025):
            dq, dkdv, rows, keys = tattn.f32_k3_route(t, d)
            assert (dq, dkdv) == ("attn_wide_bwd_dq_kernel", "attn_wide_bwd_dkdv_kernel")
            assert (rows, keys) == (16, 64 if d == 128 else 32)
            assert _dq_bytes(t, d) <= SMEM
        assert _dkdv_bytes(d) <= SMEM
        # dq: 16 rows x D columns in RMO x 4 tiles; dk/dv: BK rows
        cg = d // 4
        assert (THREADS // cg) * (16 // (THREADS // cg)) == 16
        assert (THREADS // cg) * ((64 if d == 128 else 32) // (THREADS // cg)) == keys
    assert _dq_bytes(1024, 256) == 232192 and _dq_bytes(1024, 128) == 216832
    assert (_dkdv_bytes(128), _dkdv_bytes(256)) == (154368, 209664)
    assert tattn.f32_k3_route(256, 64)[:2] == ("attn_row_bwd_dq_kernel",
                                               "attn_row_bwd_dkdv_kernel")
    assert tattn.f32_k3_route(257, 72)[:2] == ("attn_long_bwd_dq_kernel",
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
