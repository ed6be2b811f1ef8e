"""Port parity of the rest of the ODE surface: the bosh3, adaptive_heun and
dopri8 tableaus and step control, the ``eval_noise`` floor, the Karras
euler / heun samplers and ``sample_latents``' dispatch and NFE, against
lfm_tpu on the CPU (the JAX side jitted).

Tolerances: the tableaus are JAX's to the bit. The adaptive runs take the
same decisions (accept / reject rows, steps, rejects, NFE) as JAX's in f32;
their step sizes then differ only by the two frameworks' f32 reduction
orders in the error norm, and the final state agrees within 1e-5
relative. On a field rounded to bf16 (both packages round to nearest
even) the floored runs take JAX's decisions too, and the calibrated level
agrees within 1e-5 relative. The Karras loops agree within 1e-6 relative
(f32 axpys over the same sigmas); churned heun matches a float64 numpy
transliteration fed the port's own draws within 1e-5.
"""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found, rel_err  # noqa: E402,F401

from lfm_tpu.core import config as jconfig  # noqa: E402
from lfm_tpu.ode import solvers as jsolvers  # noqa: E402
from lfm_tpu.sample import sample as jsample  # noqa: E402
from lfm_tpu_torch.core import config as tconfig  # noqa: E402
from lfm_tpu_torch.ode import solvers as tsolvers  # noqa: E402
from lfm_tpu_torch.sample import sample as tsample  # noqa: E402

_MU, _SIG = 1.5, 0.5
ADAPTIVE = ["bosh3", "adaptive_heun", "dopri8"]
MAX_STEPS = 3000


def _gauss_flow(t, y):
    """Closed-form flow-matching velocity of a Gaussian target, N(1.5,
    0.5^2), in jax.numpy or torch alike (tests/test_torch_ode.py's field)."""
    a, b = 1.0 - t, t
    var = a * a * _SIG * _SIG + b * b
    m0 = _MU + (a * _SIG * _SIG) * (y - a * _MU) / var
    m1 = b * (y - a * _MU) / var
    return m1 - m0


def _gauss_bf16_jax(t, y):
    return _gauss_flow(t, y).astype(jnp.bfloat16).astype(jnp.float32)


def _gauss_bf16_torch(t, y):
    return _gauss_flow(t, y).to(torch.bfloat16).float()


def _y0(shape=(64,), seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_adaptive(field, y0, method, eval_noise):
    run = jax.jit(lambda y: jsolvers._odeint_adaptive(field, y, 1.0, 0.0, method, 1e-5, 1e-5,
                                                      MAX_STEPS, eval_noise=eval_noise,
                                                      record_trace=True))
    res, trace = run(jnp.asarray(y0))
    n = int(res.num_steps) + int(res.num_rejected)
    return res, [np.asarray(a)[:n] for a in trace]


def _assert_same_decisions(tres, ttrace, jres, jtrace):
    assert (tres.num_steps, tres.num_rejected, tres.nfe) == (
        int(jres.num_steps), int(jres.num_rejected), float(jres.nfe))
    j_t, j_dt, j_acc, _ = jtrace
    assert [r[2] for r in ttrace] == j_acc.tolist()
    np.testing.assert_allclose(ttrace[0][:2], [j_t[0], j_dt[0]], rtol=1e-5)


@pytest.mark.parametrize("method", ["dopri5"] + ADAPTIVE)
def test_tableau_equals_jax_to_the_bit(method):
    got, want = tsolvers.get_tableau(method), jsolvers._get_tableau(method)
    for field in ("order", "c", "a", "b", "b_err", "fsal", "c_mid"):
        assert getattr(got, field) == getattr(want, field), field
    # dopri8's virtual 13th stage is the FSAL evaluation at t + dt, y1
    if method == "dopri8":
        assert len(got.c) == 13 and got.c[-1] == 1.0 and got.a[-1] == got.b[:12]


@pytest.mark.parametrize("method", ADAPTIVE)
def test_adaptive_f32_matches_jax_decision_for_decision(method):
    """Each clamped method against lfm_tpu's _odeint_adaptive in f32 on the
    Gaussian field: the same record_trace rows' decisions, steps, rejects
    and NFE, the final state within 1e-5, and the last step landing on t1
    exactly (JAX's semantics, not torchdiffeq's free stepping)."""
    y0 = _y0()
    jres, jtrace = _jax_adaptive(_gauss_flow, y0, method, 0.0)
    tres, ttrace = tsolvers.odeint(_gauss_flow, torch.from_numpy(y0), 1.0, 0.0, method=method,
                                   max_steps=MAX_STEPS, record_trace=True)
    _assert_same_decisions(tres, ttrace, jres, jtrace)
    assert tres.num_steps >= 2 and tres.t_end == 0.0
    assert rel_err(tres.y, jres.y) < 1e-5
    evals = {"bosh3": 3, "adaptive_heun": 2, "dopri8": 12}[method]
    assert tres.nfe == 2 + evals * (tres.num_steps + tres.num_rejected)


@pytest.mark.parametrize("method,eval_noise", [(m, e) for m in ADAPTIVE for e in (0.01, "auto")]
                         + [("dopri5", 0.01)])
def test_eval_noise_floor_matches_jax_on_a_bf16_field(method, eval_noise):
    """The floor on a field whose output is rounded to bf16: the same
    decisions and NFE as JAX's (``"auto"`` evaluates once more). Step sizes
    that differ in their last f32 bits move a stage's evaluation point, and
    a bf16 rounding there may fall the other way, so the final state is
    held to one bf16 rounding (2^-8 relative), not to f32's 1e-5. Such a
    controller sits at ratio ~1 by design, so its decisions can hang on
    those bits: dopri5 under "auto" on this field starts from an initial
    step one f32 ulp off JAX's (its reductions' order) and parts from JAX's
    decisions at the 8th row; the other cases here take JAX's throughout."""
    y0 = _y0()
    jres, jtrace = _jax_adaptive(_gauss_bf16_jax, y0, method, eval_noise)
    tres, ttrace = tsolvers.odeint(_gauss_bf16_torch, torch.from_numpy(y0), 1.0, 0.0,
                                   method=method, max_steps=MAX_STEPS, eval_noise=eval_noise,
                                   record_trace=True)
    _assert_same_decisions(tres, ttrace, jres, jtrace)
    assert rel_err(tres.y, jres.y) < 2.0 ** -8


def test_calibrated_level_matches_jax():
    """The ``"auto"`` level: 1.5 rms(f(y0 + 1e-4 (|y0| + 1)) - f(y0)) /
    (sqrt(2) rms(f(y0))), lfm_tpu/ode/solvers.py:406-411, evaluated here in
    jax.numpy on the bf16 field, against the port's calibrate_eval_noise."""
    y0 = _y0()

    @jax.jit
    def jax_level(y):
        t0 = jnp.asarray(1.0, jnp.float32)
        f0 = _gauss_bf16_jax(t0, y)
        f_probe = _gauss_bf16_jax(t0, y + 1e-4 * (jnp.abs(y) + 1.0))
        rms = lambda x: jnp.sqrt(jnp.sum(jnp.square(x)) / x.size)  # noqa: E731
        return 1.5 * rms(f_probe - f0) / (jnp.sqrt(2.0) * (rms(f0) + 1e-20))

    want = float(jax_level(jnp.asarray(y0)))
    t0 = torch.tensor(1.0)
    y = torch.from_numpy(y0)
    got = float(tsolvers.calibrate_eval_noise(_gauss_bf16_torch, t0, y, _gauss_bf16_torch(t0, y),
                                              torch.float32))
    assert want > 1e-4 and abs(got - want) <= 1e-5 * want


def test_zero_eval_noise_is_the_unfloored_controller():
    y0 = torch.from_numpy(_y0())
    a, ta = tsolvers.odeint(_gauss_bf16_torch, y0, method="dopri5", record_trace=True)
    b, tb = tsolvers.odeint(_gauss_bf16_torch, y0, method="dopri5", eval_noise=0.0,
                            record_trace=True)
    assert ta == tb and torch.equal(a.y, b.y) and a.nfe == b.nfe


@pytest.mark.parametrize("eval_noise,method,bf16", [
    (None, "dopri8", True), (None, "dopri8", False), (None, "dopri5", True),
    (None, "bosh3", True), (0.02, "dopri8", True), ("auto", "dopri5", False),
    (0.0, "dopri8", True)])
def test_resolve_eval_noise_table(eval_noise, method, bf16):
    want = jsample.resolve_eval_noise(
        jconfig.SampleConfig(method=method, eval_noise=eval_noise),
        types.SimpleNamespace(dtype=jnp.bfloat16 if bf16 else jnp.float32))
    got = tsample.resolve_eval_noise(
        tconfig.SampleConfig(method=method, eval_noise=eval_noise),
        types.SimpleNamespace(dtype=torch.bfloat16 if bf16 else torch.float32))
    assert got == want and type(got) is type(want)


def _counted(f):
    calls = []

    def g(x, sigma):
        calls.append(1)
        return f(sigma, x)

    return g, calls


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("sampler", ["euler", "heun"])
@pytest.mark.parametrize("steps", [4, 40, 45])
def test_karras_matches_jax(steps, sampler, clip):
    """40 and 45 steps reach past the reference's 39-pair correction guard:
    heun then takes plain Euler for the tail, as JAX does."""
    y0 = np.random.default_rng(3).standard_normal((2, 4, 4, 4)).astype(np.float32)
    want = jax.jit(lambda y: jsolvers.karras_sample(lambda x, s: _gauss_flow(s, x), y, steps,
                                                    sampler=sampler, clip_denoised=clip))(
        jnp.asarray(y0))
    fn, calls = _counted(_gauss_flow)
    got = tsolvers.karras_sample(fn, torch.from_numpy(y0), steps, sampler=sampler,
                                 clip_denoised=clip)
    assert rel_err(got, want) < 1e-6
    pairs = steps - 1
    assert len(calls) == (pairs + min(pairs, 39) if sampler == "heun" else pairs)


def _heun_churn_f64(x, sigmas, draws, s_churn, s_tmin, s_tmax, s_noise):
    """sample_heun_karras transliterated into float64 numpy, fed the draws."""
    sigmas = np.asarray(sigmas, np.float64)
    gamma_const = min(s_churn / 40, np.sqrt(2) - 1)
    for i in range(len(sigmas) - 1):
        t_cur, t_next = sigmas[i], sigmas[i + 1]
        gamma = gamma_const if s_tmin <= t_cur <= s_tmax else 0.0
        t_hat = t_cur + gamma * t_cur
        x_hat = x + np.sqrt(max(t_hat ** 2 - t_cur ** 2, 0.0)) * s_noise * draws[i]
        d = _gauss_flow(t_hat, x_hat)
        x = x_hat + (t_next - t_hat) * d
        if i < 39:
            x = x_hat + (t_next - t_hat) * (0.5 * d + 0.5 * _gauss_flow(t_next, x))
    return x


def test_heun_churn_matches_float64_with_the_ports_draws():
    """Churn draws one torch.randn(x.shape) a step from the generator, in
    step order (JAX's fold_in bits cannot be shared)."""
    y0 = np.random.default_rng(4).standard_normal((2, 4, 4, 4)).astype(np.float32)
    steps, kw = 12, dict(s_churn=10.0, s_tmin=0.2, s_tmax=0.8, s_noise=0.9)
    got = tsolvers.karras_sample(lambda x, s: _gauss_flow(s, x), torch.from_numpy(y0), steps,
                                 generator=torch.Generator().manual_seed(5), **kw)
    g = torch.Generator().manual_seed(5)
    draws = [torch.randn(y0.shape, generator=g).double().numpy() for _ in range(steps - 1)]
    sigmas = tsolvers.karras_sigmas(steps).numpy()
    want = _heun_churn_f64(y0.astype(np.float64), sigmas, draws, **kw)
    assert rel_err(got, want) < 1e-5
    plain = tsolvers.karras_sample(lambda x, s: _gauss_flow(s, x), torch.from_numpy(y0), steps)
    assert rel_err(got, plain) > 1e-3  # the churn did move the sample


def test_churn_outside_its_window_is_no_churn():
    y0 = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 4, 4, 4))
                          .astype(np.float32))
    out = tsolvers.karras_sample(lambda x, s: _gauss_flow(s, x), y0, 10, s_churn=10.0,
                                 s_tmin=2.0, s_tmax=3.0,
                                 generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, tsolvers.karras_sample(lambda x, s: _gauss_flow(s, x), y0, 10))


@pytest.mark.parametrize("method,steps,karras", [
    ("heun", 45, True), ("heun", 4, True), ("euler", 40, True), ("rk4", 6, True),
    ("bosh3", 40, False), ("dopri8", 40, False), ("midpoint", 5, False)])
def test_sample_latents_nfe_matches_jax(method, steps, karras):
    """Karras: JAX's formula; a Karras run of any other method takes euler.
    The latents too, within 1e-5."""
    y0 = np.random.default_rng(6).standard_normal((2, 4, 4, 4)).astype(np.float32)
    jz, jnfe = jax.jit(lambda y: jsample.sample_latents(_gauss_flow, y, method=method,
                                                        num_steps=steps, use_karras=karras))(
        jnp.asarray(y0))
    calls = []

    def velocity(t, x):
        calls.append(1)
        return _gauss_flow(t, x)

    tz, tnfe = tsample.sample_latents(velocity, torch.from_numpy(y0), method=method,
                                      num_steps=steps, use_karras=karras)
    assert tnfe == float(jnfe) == len(calls)
    assert rel_err(tz, jz) < 1e-5
