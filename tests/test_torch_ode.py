"""Port parity: lfm_tpu_torch.ode (flow, cfg, fixed solvers, dopri5) and
core.rng against lfm_tpu and tests/tdq_ref.py, on the CPU.

Tolerances: f32 paths agree to ~1e-5 relative (the same arithmetic, sums
reduced in another order); the f64 dopri5 run matches the f64 oracle with
the tolerances of tests/test_controller_trace.py. jax_enable_x64 is never turned on.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import tdq_ref  # noqa: E402
from tests.torch_parity import leaves_process_as_found, rel_err  # noqa: E402,F401

from lfm_tpu.ode import cfg as jcfg  # noqa: E402
from lfm_tpu.ode import flow as jflow  # noqa: E402
from lfm_tpu.ode.solvers import _odeint_adaptive, odeint as jodeint  # noqa: E402
from lfm_tpu_torch.core.rng import SampleRNG  # noqa: E402
from lfm_tpu_torch.ode import cfg as tcfg  # noqa: E402
from lfm_tpu_torch.ode import flow as tflow  # noqa: E402
from lfm_tpu_torch.ode.solvers import odeint as todeint  # noqa: E402

F32_TOL = 1e-5
_MU, _SIG = 1.5, 0.5
_A = np.array([[-0.5, 1.2], [-1.2, -0.5]])


def _gauss_flow(xp):
    """Closed-form flow-matching velocity of a Gaussian target, in numpy,
    jax.numpy or torch (xp)."""
    def f(t, y):
        a, b = 1.0 - t, t
        var = a * a * _SIG * _SIG + b * b
        m0 = _MU + (a * _SIG * _SIG) * (y - a * _MU) / var
        m1 = b * (y - a * _MU) / var
        return m1 - m0
    return f


def _linear_np(t, y):
    return (y.reshape(-1, 2) @ _A.T).reshape(y.shape)


def _linear_jnp(t, y):
    return (y.reshape(-1, 2) @ jnp.asarray(_A.T, y.dtype)).reshape(y.shape)


def _linear_torch(t, y):
    return (y.reshape(-1, 2) @ torch.as_tensor(_A.T, dtype=y.dtype)).reshape(y.shape)


def _decay_np(t, y):
    return -24.0 * (y - np.sin(6.0 * t)) + 6.0 * np.cos(6.0 * t)


def _poly_np(t, y):
    return np.stack([3 * t * t * np.ones_like(y[..., 0]),
                     np.cos(8.0 * t) * np.ones_like(y[..., 0])], axis=-1)


def test_interpolate_parity():
    rng = np.random.default_rng(0)
    z0, z1 = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    t = rng.uniform(size=(3,)).astype(np.float32)
    jz, ju = jflow.interpolate(jnp.asarray(z0), jnp.asarray(z1), jnp.asarray(t))
    tz, tu = tflow.interpolate(torch.from_numpy(z0), torch.from_numpy(z1), torch.from_numpy(t))
    assert rel_err(tz, jz) < F32_TOL
    assert rel_err(tu, ju) < F32_TOL


def test_fm_loss_is_mse_to_the_target_velocity():
    """The port's fm_loss draws t and noise from a torch.Generator (JAX's
    threefry bits cannot be reproduced), so it is held to its definition:
    the exact target velocity gives loss 0 and a zero field gives E|u|^2."""
    z0 = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 2, 2, 3)).astype(np.float32))

    def exact(t, z_t, y):
        tt = t.reshape(-1, 1, 1, 1)
        z1 = (z_t - (1.0 - tt) * z0) / (tflow.SIGMA_MIN + (1.0 - tflow.SIGMA_MIN) * tt)
        return (1.0 - tflow.SIGMA_MIN) * z1 - z0

    g = torch.Generator().manual_seed(0)
    assert float(tflow.fm_loss(exact, z0, g)) < 1e-8
    g = torch.Generator().manual_seed(0)
    loss = float(tflow.fm_loss(lambda t, z, y: torch.zeros_like(z), z0, g))
    assert loss > 0.5


@pytest.mark.parametrize("guide_channels", [None, 2])
def test_cfg_and_plain_velocity_parity(guide_channels):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    w = rng.standard_normal((4, 4)).astype(np.float32)
    emb = rng.standard_normal((5, 4)).astype(np.float32)
    y = np.array([0, 3, 1])
    y_null = np.full_like(y, 4)

    def jmodel(t, xx, yy):
        return jnp.tanh(xx @ jnp.asarray(w) + jnp.asarray(emb)[yy][:, None, None, :]) * t[:, None, None, None]

    def tmodel(t, xx, yy):
        return torch.tanh(xx @ torch.from_numpy(w) + torch.from_numpy(emb)[yy][:, None, None, :]) * t[:, None, None, None]

    jv = jcfg.cfg_velocity(jmodel, jnp.asarray(y), jnp.asarray(y_null), 1.5, guide_channels)(0.3, jnp.asarray(x))
    tv = tcfg.cfg_velocity(tmodel, torch.from_numpy(y), torch.from_numpy(y_null), 1.5,
                           guide_channels)(0.3, torch.from_numpy(x))
    assert rel_err(tv, jv) < F32_TOL
    jp = jcfg.plain_velocity(jmodel, jnp.asarray(y))(0.7, jnp.asarray(x))
    tp = tcfg.plain_velocity(tmodel, torch.from_numpy(y))(0.7, torch.from_numpy(x))
    assert rel_err(tp, jp) < F32_TOL


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4"])
def test_fixed_solvers_parity(method):
    y0 = np.random.default_rng(3).standard_normal((2, 4, 4, 4)).astype(np.float32)
    jres = jodeint(_gauss_flow(jnp), jnp.asarray(y0), 1.0, 0.0, method=method, num_steps=7)
    tres = todeint(_gauss_flow(torch), torch.from_numpy(y0), 1.0, 0.0, method=method, num_steps=7)
    assert tres.nfe == float(jres.nfe)
    assert tres.num_steps == int(jres.num_steps)
    assert rel_err(tres.y, jres.y) < F32_TOL


@pytest.mark.parametrize("field", ["linear", "gauss_flow"])
def test_dopri5_f32_matches_jax_decision_for_decision(field):
    """The f32 controller against lfm_tpu's _odeint_adaptive in f32: the same
    initial step, accept/reject sequence, step count and NFE. The first
    step's error estimate sits at f32 round-off (ratio ~1e-5), where the two
    frameworks' reduction orders differ by ~20%, so later step sizes differ
    by a few percent and the endpoints agree to the solver's tolerance
    (1e-4 relative), not to the last bit."""
    y0 = np.random.default_rng(7).standard_normal((6,)).astype(np.float32)
    jf, tf = {"linear": (_linear_jnp, _linear_torch),
              "gauss_flow": (_gauss_flow(jnp), _gauss_flow(torch))}[field]
    jres, jtrace = _odeint_adaptive(jf, jnp.asarray(y0), 1.0, 0.0, "dopri5", 1e-5, 1e-5,
                                    200, record_trace=True)
    tres, ttrace = todeint(tf, torch.from_numpy(y0), 1.0, 0.0, method="dopri5", max_steps=200,
                           record_trace=True)
    n = int(jres.num_steps) + int(jres.num_rejected)
    assert (tres.num_steps, tres.num_rejected, tres.nfe) == (
        int(jres.num_steps), int(jres.num_rejected), float(jres.nfe))
    assert len(ttrace) == n and n >= 3
    j_t, j_dt, j_acc, _ = (np.asarray(a)[:n] for a in jtrace)
    assert [r[2] for r in ttrace] == j_acc.tolist()
    np.testing.assert_allclose(ttrace[0][:2], [j_t[0], j_dt[0]], rtol=F32_TOL)
    assert rel_err(tres.y, jres.y) < 1e-4


@pytest.mark.parametrize("name,f,t0,t1", [
    ("linear", _linear_np, 1.0, 0.0),
    ("decay_forced", _decay_np, 0.0, 1.0),
    ("gauss_flow", _gauss_flow(np), 1.0, 0.0),
    ("poly", _poly_np, 1.0, 0.0),
], ids=["linear", "decay_forced", "gauss_flow", "poly"])
def test_dopri5_f64_matches_torchdiffeq_oracle(name, f, t0, t1):
    """The port in float64 against tests/tdq_ref.py (float64 NumPy
    torchdiffeq) directly: no JAX involved, no x64 flag."""
    rng = np.random.default_rng(7)
    y0 = rng.normal(size=(4, 2)) if name == "poly" else rng.normal(size=(6,))
    ref_y, ref_nfe, ref_steps, ref_rej, ref_trace = tdq_ref.odeint_dopri5(
        f, y0, t0, t1, rtol=1e-5, atol=1e-5)

    def tf(t, y):
        return torch.from_numpy(np.asarray(f(float(t), y.numpy()), np.float64))

    res, trace = todeint(tf, torch.from_numpy(y0), t0, t1, method="dopri5", record_trace=True)
    assert (res.num_steps, res.num_rejected, res.nfe) == (ref_steps, ref_rej, float(ref_nfe))
    assert [r[2] for r in trace] == [r[2] for r in ref_trace]
    # the tolerances of tests/test_controller_trace.py
    got, want = np.array(trace, np.float64), np.array(ref_trace, np.float64)
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(res.y.numpy(), ref_y, rtol=1e-9, atol=1e-10)


def test_sample_rng_is_batch_and_rank_invariant():
    rng = SampleRNG(seed=42, num_samples=100)
    whole = rng.randn(range(8), (4, 4, 4), device="cpu")
    halves = torch.cat([rng.randn([0, 1, 2, 3], (4, 4, 4), device="cpu"),
                        rng.randn(torch.arange(4, 8), (4, 4, 4), device="cpu")])
    assert torch.equal(whole, halves)
    # two ranks draw the interleaved halves of the same index space
    r0 = rng.randn(rng.batch_indices(0, 4, rank=0, world_size=2), (4, 4, 4), device="cpu")
    r1 = rng.randn(rng.batch_indices(0, 4, rank=1, world_size=2), (4, 4, 4), device="cpu")
    assert torch.equal(whole[0::2], r0) and torch.equal(whole[1::2], r1)
    assert not torch.equal(whole[0], whole[1])
    assert abs(float(whole.mean())) < 0.2 and abs(float(whole.std()) - 1.0) < 0.1
    labels = rng.randint(range(64), 0, 10, device="cpu")
    assert torch.equal(labels, rng.randint(range(64), 0, 10, device="cpu"))
    assert int(labels.min()) >= 0 and int(labels.max()) < 10 and len(set(labels.tolist())) > 3
    assert not torch.equal(SampleRNG(seed=43).randn([0], (4,), device="cpu"), whole[0, 0, 0][None])
