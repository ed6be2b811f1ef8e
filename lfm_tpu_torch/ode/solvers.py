"""ODE solvers for flow-matching sampling (port of lfm_tpu/ode/solvers.py).

The JAX package runs these loops as ``lax.scan`` / ``lax.while_loop`` only
because XLA needs static control flow. Here the loop runs on the host, one
Python iteration per step; the velocity evaluations stay on the device.

* fixed-step solvers: euler, midpoint, heun, rk4;
* adaptive dopri5, bosh3, adaptive_heun and dopri8 (Hairer's DOP853
  coefficients with its 5th-order error estimate) with torchdiffeq's
  controller: the Hairer initial step, accept iff the RMS error ratio
  <= 1, step factor min(ifactor, max(safety * ratio^(-1/order), dfactor'))
  with safety=0.9, ifactor=10, dfactor=0.2 (dfactor'=1 after an accepted
  step). dopri5 steps freely past t1 and returns the quartic dense-output
  fit evaluated at t1 (the reference's torchdiffeq semantics); the other
  three clamp the final step to land exactly on t1, as the JAX package
  does;
* the ``eval_noise`` floor: the embedded error's part that comes from the
  velocity's own rounding noise, |dt| * eval_noise * sqrt(sum_i b_err_i^2
  k_i^2) per element, is subtracted from the error ratio in quadrature
  (a float, or ``"auto"`` to calibrate it with one probe evaluation at
  t0); 0.0 gives torchdiffeq's controller unchanged;
* the Karras samplers (reference sampler/karras_sample.py): euler and heun
  over a linear sigma schedule, with churn.

Controller arithmetic runs in float32, or in float64 when the state is
float64 (the JAX package's ``_acc``: f64 only under jax_enable_x64). The
state is one tensor.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist

ADAPTIVE_SOLVERS = ("dopri5", "dopri8", "adaptive_heun", "bosh3")
FIXED_SOLVERS = ("euler", "midpoint", "rk4", "heun")

Velocity = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
EvalNoise = Union[float, str, torch.Tensor]


class ODEResult(NamedTuple):
    y: torch.Tensor
    nfe: float  # number of function evaluations
    num_steps: int
    num_rejected: int
    # the adaptive loop's last t: t1 exactly for the methods that clamp
    # their final step, past it for dopri5 (None for the fixed-step solvers)
    t_end: Optional[float] = None


def _acc_dtype(y: torch.Tensor) -> torch.dtype:
    return torch.float64 if y.dtype == torch.float64 else torch.float32


def _weighted_sum(ks: Sequence[torch.Tensor], coeffs, scale, acc_t):
    """sum_i (scale * coeffs[i]) * ks[i] in ``acc_t``, zero coefficients
    skipped, left to right (ode/solvers.py's generator sums)."""
    acc = None
    for c, k in zip(coeffs, ks):
        if c != 0.0:
            term = (scale * c) * k.to(acc_t)
            acc = term if acc is None else acc + term
    return acc


def _combine(y0: torch.Tensor, ks: Sequence[torch.Tensor], coeffs, dt) -> torch.Tensor:
    """y0 + dt * sum_i coeffs[i] * ks[i], accumulated in the controller
    dtype, zero coefficients skipped (ode/solvers.py::_combine)."""
    acc_t = _acc_dtype(y0)
    acc = y0.to(acc_t)
    for c, k in zip(coeffs, ks):
        if c != 0.0:
            acc = acc + (dt * c) * k.to(acc_t)
    return acc.to(y0.dtype)


def _mean_square(x: torch.Tensor, group=None) -> torch.Tensor:
    """mean(x^2) over x, or over the batch of which x is one rank's equal
    share when ``group`` (the ranks that split the batch) is given: the
    squares' sum all-reduced, so every rank steps alike, as JAX's one
    controller over the global batch."""
    s = torch.sum(torch.square(x))
    if group is None:
        return s / x.numel()
    dist.all_reduce(s, group=group)
    return s / (x.numel() * dist.get_world_size(group))


def _rms_norm(x: torch.Tensor, acc_t, group=None) -> torch.Tensor:
    return torch.sqrt(_mean_square(x.to(acc_t), group))


def _error_ratio(err, y0, y1, rtol, atol, acc_t, group=None) -> torch.Tensor:
    """RMS of err / (atol + rtol * max(|y0|, |y1|)): torchdiffeq's norm."""
    tol = atol + rtol * torch.maximum(y0.abs(), y1.abs()).to(acc_t)
    return torch.sqrt(_mean_square(err.to(acc_t) / tol, group))


@dataclasses.dataclass(frozen=True)
class Tableau:
    order: int  # the step-size exponent's order (torchdiffeq: the solver's)
    c: tuple  # nodes
    a: tuple  # row i gives stage i's combination of k_0 .. k_{i-1}
    b: tuple  # solution weights
    b_err: tuple  # b - b_hat: the embedded error estimate's weights
    fsal: bool = False  # first same as last: the last stage is f(t + dt, y1)
    c_mid: tuple = ()  # midpoint weights of dopri5's quartic dense-output fit


# Butcher tableaus (public-domain coefficients); dopri5's c_mid is
# torchdiffeq's DPS_C_MID
DOPRI5 = Tableau(
    order=5,
    c=(0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    a=(
        (),
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    ),
    b=(35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0),
    b_err=(
        35 / 384 - 1951 / 21600, 0.0, 500 / 1113 - 22642 / 50085,
        125 / 192 - 451 / 720, -2187 / 6784 + 12231 / 42400,
        11 / 84 - 649 / 6300, -1 / 60,
    ),
    fsal=True,
    c_mid=(
        6025192743 / 30085553152 / 2, 0.0, 51252292925 / 65400821598 / 2,
        -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
        -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2,
    ),
)

BOSH3 = Tableau(
    order=3,
    c=(0.0, 1 / 2, 3 / 4, 1.0),
    a=((), (1 / 2,), (0.0, 3 / 4), (2 / 9, 1 / 3, 4 / 9)),
    b=(2 / 9, 1 / 3, 4 / 9, 0.0),
    b_err=(2 / 9 - 7 / 24, 1 / 3 - 1 / 4, 4 / 9 - 1 / 3, -1 / 8),
    fsal=True,
)

ADAPTIVE_HEUN = Tableau(
    order=2,
    c=(0.0, 1.0),
    a=((), (1.0,)),
    b=(1 / 2, 1 / 2),
    b_err=(1 / 2, -1 / 2),
    fsal=False,
)


@functools.lru_cache(maxsize=None)
def dop853_tableau() -> Tableau:
    """dopri8: Hairer's DOP853 coefficients, read from scipy's published
    tables as the JAX package reads them, with its 5th-order error estimate
    E5. E5 has one weight more than the 12 stages: it multiplies
    f(t + dt, y1), so a 13th stage with the solution weights as its row
    hosts it, and that stage is the next step's first (FSAL)."""
    from scipy.integrate._ivp import dop853_coefficients as dc

    ns = dc.N_STAGES  # 12
    a = tuple(tuple(float(x) for x in dc.A[i, :i]) for i in range(ns))
    a = a + (tuple(float(x) for x in dc.B),)
    return Tableau(order=8, c=tuple(float(x) for x in dc.C[:ns]) + (1.0,), a=a,
                   b=tuple(float(x) for x in dc.B) + (0.0,),
                   b_err=tuple(float(x) for x in dc.E5), fsal=True)


def get_tableau(method: str) -> Tableau:
    if method == "dopri8":
        return dop853_tableau()
    return {"dopri5": DOPRI5, "bosh3": BOSH3, "adaptive_heun": ADAPTIVE_HEUN}[method]


def _rk_step(func: Velocity, tab: Tableau, t, dt, y0, f0):
    """One explicit RK step. Returns (y1, f1, err, evals, ks): an FSAL
    tableau's f1 is its last stage, any other evaluates f(t + dt, y1) here,
    so that ``evals`` counts what JAX's ``k_evals_used`` counts."""
    acc_t = _acc_dtype(y0)
    ks = [f0]
    for i in range(1, len(tab.c)):
        ks.append(func(t + tab.c[i] * dt, _combine(y0, ks, tab.a[i], dt)))
    y1 = _combine(y0, ks, tab.b, dt)
    err = _weighted_sum(ks, tab.b_err, dt, acc_t)
    f1 = ks[-1] if tab.fsal else func(t + dt, y1)
    evals = (len(tab.c) - 1) + (0 if tab.fsal else 1)
    return y1, f1, err, evals, ks


def _interp_fit(y0, y1, ks, dt, c_mid) -> List[torch.Tensor]:
    """torchdiffeq's quartic dense-output fit (rk_common.py::_interp_fit),
    coefficients highest power first, in x = (t - t0) / dt."""
    acc_t = _acc_dtype(y0)
    y0f, y1f = y0.to(acc_t), y1.to(acc_t)
    ym = y0f + dt * _weighted_sum(ks, c_mid, 1.0, acc_t)
    f0 = dt * ks[0].to(acc_t)
    f1 = dt * ks[-1].to(acc_t)
    a = 2.0 * (f1 - f0) - 8.0 * (y1f + y0f) + 16.0 * ym
    b = 5.0 * f0 - 3.0 * f1 + 18.0 * y0f + 14.0 * y1f - 32.0 * ym
    c = f1 - 4.0 * f0 - 11.0 * y0f - 5.0 * y1f + 16.0 * ym
    return [a, b, c, f0, y0f]


def _initial_step(func, t0, y0, f0, order, rtol, atol, direction, group=None):
    """Hairer/Wanner initial-step heuristic (as in torchdiffeq and scipy)."""
    acc_t = _acc_dtype(y0)
    scale = atol + rtol * y0.to(acc_t).abs()
    d0 = _rms_norm(y0.to(acc_t) / scale, acc_t, group)
    d1 = _rms_norm(f0.to(acc_t) / scale, acc_t, group)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.ones_like(d0) * 1e-6,
                     0.01 * d0 / d1)
    y1 = y0 + (h0 * direction) * f0.to(y0.dtype)
    f1 = func(t0 + h0 * direction, y1)
    d2 = _rms_norm((f1 - f0).to(acc_t) / scale, acc_t, group) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / dmax) ** (1.0 / (order + 1)))
    return torch.minimum(100.0 * h0, h1)


def calibrate_eval_noise(func: Velocity, t0, y0: torch.Tensor, f0: torch.Tensor,
                         acc_t, group=None) -> torch.Tensor:
    """``eval_noise="auto"``: one probe evaluation at t0 with y0 displaced
    by 1e-4 (|y0| + 1), far enough that low-precision rounding decorrelates
    and near enough that the true field barely moves. The rms difference
    of the two evaluations is sqrt(2) times the noise of one; the factor
    1.5 is the JAX package's (swept on its chip for a bf16 DiT-L/2)."""
    y_probe = y0 + 1e-4 * (y0.abs() + 1.0)
    f_probe = func(t0, y_probe)
    diff = _rms_norm(f_probe.to(acc_t) - f0.to(acc_t), acc_t, group)
    return 1.5 * diff / (math.sqrt(2.0) * (_rms_norm(f0, acc_t, group) + 1e-20))


def _odeint_adaptive(func: Velocity, y0: torch.Tensor, t0: float, t1: float,
                     method: str, rtol: float, atol: float, max_steps: int,
                     safety: float = 0.9, ifactor: float = 10.0,
                     dfactor: float = 0.2, eval_noise: EvalNoise = 0.0,
                     record_trace: bool = False, group=None):
    """torchdiffeq-style adaptive integration (ode/solvers.py::
    _odeint_adaptive). With ``record_trace`` also returns one (t, dt,
    accepted, error_ratio) row per attempted step, the ratio after the
    noise floor."""
    tab = get_tableau(method)
    dense = method == "dopri5"
    acc_t = _acc_dtype(y0)
    dev = y0.device
    direction = 1.0 if t1 >= t0 else -1.0
    t = torch.tensor(t0, dtype=acc_t, device=dev)
    t1_t = torch.tensor(t1, dtype=acc_t, device=dev)
    t1_f = float(t1_t)

    f = func(t, y0)
    nfe = 2.0  # f0 + the initial-step probe
    if isinstance(eval_noise, str):
        if eval_noise != "auto":
            raise ValueError(f"eval_noise must be a float or 'auto', got {eval_noise!r}")
        eval_noise = calibrate_eval_noise(func, t, y0, f, acc_t, group)
        nfe += 1.0
    floor = isinstance(eval_noise, torch.Tensor) or eval_noise > 0.0
    # torchdiffeq passes ``order - 1`` (rk_common.py): exponent 1/order
    dt = _initial_step(func, t, y0, f, tab.order - 1, rtol, atol, direction, group) * direction
    steps, rejected = 0, 0
    y = y0
    coeffs, t_prev, h_prev = None, t, None
    trace = []

    while steps + rejected < max_steps:
        t_f = float(t)
        if not (abs(t_f - t1_f) > 1e-12 and (t_f - t1_f) * direction < 0):
            break
        on_boundary = None
        if not dense:
            # clamp the step so that the last one lands exactly on t1
            remaining = t1_t - t
            dt = torch.where(dt.abs() > remaining.abs(), remaining, dt)
            on_boundary = dt.abs() >= remaining.abs() - 1e-12
        y1, f1, err, evals, ks = _rk_step(func, tab, t, dt, y, f)
        ratio = _error_ratio(err, y, y1, rtol, atol, acc_t, group)
        if floor:
            # the embedded error's noise part under independent rounding of
            # each stage (the correlated part cancels: sum_i b_err_i == 0)
            var = _weighted_sum([torch.square(k.to(acc_t)) for k in ks],
                                [c * c for c in tab.b_err], 1.0, acc_t)
            noise = dt.abs() * eval_noise * torch.sqrt(var)
            noise_ratio = _error_ratio(noise, y, y1, rtol, atol, acc_t, group)
            ratio = torch.sqrt(torch.clamp(torch.square(ratio) - torch.square(noise_ratio),
                                           min=0.0))
        ratio_f = float(ratio)
        accept = ratio_f <= 1.0
        if record_trace:
            trace.append((t_f, float(dt), accept, ratio_f))
        nfe += evals
        if ratio_f == 0.0:
            factor = torch.full_like(ratio, ifactor)
        else:
            dfac = 1.0 if ratio_f < 1.0 else dfactor
            factor = torch.clamp(torch.clamp(safety * ratio ** (-1.0 / tab.order),
                                             min=dfac), max=ifactor)
        if accept:
            if dense:
                coeffs = _interp_fit(y, y1, ks, dt, tab.c_mid)
                t_prev, h_prev = t, dt
                t = t + dt
            else:
                t = torch.where(on_boundary, t1_t, t + dt)
            y, f = y1, f1
            steps += 1
        else:
            rejected += 1
        dt = dt * factor

    y_out = y
    if coeffs is not None:
        # Horner in x = (t1 - t_prev) / h (torchdiffeq _interp_evaluate)
        x = (t1_t - t_prev) / h_prev
        acc = coeffs[0]
        for m in range(1, 5):
            acc = acc * x + coeffs[m]
        y_out = acc.to(y.dtype)
    res = ODEResult(y=y_out, nfe=nfe, num_steps=steps, num_rejected=rejected,
                    t_end=float(t))
    if record_trace:
        return res, trace
    return res


_FIXED_TABLEAUS = {
    # (c nodes, a rows, b weights)
    "euler": ((0.0,), ((),), (1.0,)),
    "midpoint": ((0.0, 0.5), ((), (0.5,)), (0.0, 1.0)),
    "heun": ((0.0, 1.0), ((), (1.0,)), (0.5, 0.5)),
    "rk4": (
        (0.0, 0.5, 0.5, 1.0),
        ((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
        (1 / 6, 1 / 3, 1 / 3, 1 / 6),
    ),
}


def _odeint_fixed(func: Velocity, y0: torch.Tensor, t0: float, t1: float,
                  method: str, num_steps: int) -> ODEResult:
    c, a, b = _FIXED_TABLEAUS[method]
    ts = torch.linspace(t0, t1, num_steps + 1, dtype=torch.float32, device=y0.device)
    y = y0
    for i in range(num_steps):
        t, dt = ts[i], ts[i + 1] - ts[i]
        ks = [func(t, y)]
        for j in range(1, len(c)):
            ks.append(func(t + c[j] * dt, _combine(y, ks, a[j], dt)))
        y = _combine(y, ks, b, dt)
    return ODEResult(y=y, nfe=float(num_steps * len(c)), num_steps=num_steps,
                     num_rejected=0)


# Karras-style fixed-sigma samplers (reference sampler/karras_sample.py)

def karras_sigmas(steps: int, sigma_min: float = 1e-5, sigma_max: float = 1.0,
                  device=None) -> torch.Tensor:
    """Linear sigma schedule sigma_max -> sigma_min (karras_sample.py:30;
    rho is unused in the reference since the schedule is linspace)."""
    return torch.linspace(sigma_max, sigma_min, steps, dtype=torch.float32, device=device)


def sample_euler_karras(denoiser, x: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """Karras Euler loop with identity ``to_d`` for flow matching
    (karras_sample.py:85-118): x <- x + v(x, sigma) * (sigma_next - sigma)."""
    for i in range(sigmas.shape[0] - 1):
        s, s_next = sigmas[i], sigmas[i + 1]
        x = x + (s_next - s) * denoiser(x, s).to(x.dtype)
    return x


def sample_heun_karras(denoiser, x: torch.Tensor, sigmas: torch.Tensor, *,
                       s_churn: float = 0.0, s_tmin: float = 0.0, s_tmax: float = 1.0,
                       s_noise: float = 1.0, generator: Optional[torch.Generator] = None,
                       steps_for_churn: int = 40) -> torch.Tensor:
    """Karras Heun loop with optional churn noise and the 2nd-order
    correction (karras_sample.py:121-161). The reference's correction
    guard is ``i < steps - 1`` with ``steps`` at its default 40 (the
    dispatch never forwards the schedule's length), so the first 39 pairs
    are corrected and a longer schedule's tail is plain Euler, as in JAX.

    Churn: gamma = min(s_churn / steps_for_churn, sqrt(2) - 1) where
    s_tmin <= sigma <= s_tmax, else 0; x_hat = x + sqrt(t_hat^2 - t^2) *
    s_noise * n. With ``s_churn > 0`` each step draws n as one
    ``torch.randn(x.shape)`` from ``generator`` (a fresh one seeded 0 when
    None), in step order. JAX folds the step index into a PRNG key instead;
    the two packages' noise bits cannot be shared, so churned samples agree
    in distribution, not value."""
    n = sigmas.shape[0] - 1
    gamma_const = min(s_churn / steps_for_churn, math.sqrt(2) - 1) if s_churn > 0 else 0.0
    if gamma_const > 0 and generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    n_corr = min(n, steps_for_churn - 1)
    for i in range(n):
        t_cur, t_next = sigmas[i], sigmas[i + 1]
        gamma = torch.where((s_tmin <= t_cur) & (t_cur <= s_tmax), gamma_const, 0.0)
        t_hat = t_cur + gamma * t_cur
        x_hat = x
        if gamma_const > 0:
            noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
            x_hat = x + torch.sqrt(torch.clamp(t_hat ** 2 - t_cur ** 2, min=0.0)) * s_noise * noise
        d_cur = denoiser(x_hat, t_hat).to(x.dtype)
        x = x_hat + (t_next - t_hat) * d_cur
        if i < n_corr:
            d_prime = denoiser(x, t_next).to(x.dtype)
            x = x_hat + (t_next - t_hat) * (0.5 * d_cur + 0.5 * d_prime)
    return x


def karras_sample(model_fn, x_T: torch.Tensor, steps: int, *, sigma_min: float = 1e-5,
                  sigma_max: float = 1.0, sampler: str = "heun", s_churn: float = 0.0,
                  s_tmin: float = 0.0, s_tmax: float = 1.0, s_noise: float = 1.0,
                  clip_denoised: bool = False,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Dispatch euler / heun over a linear sigma schedule (reference
    karras_sample.py:7-76). ``model_fn(x, sigma)`` is the velocity (already
    CFG-wrapped if needed); ``clip_denoised`` clamps it to [-1, 1]."""
    sigmas = karras_sigmas(steps, sigma_min, sigma_max, device=x_T.device)

    def denoiser(x, sigma):
        v = model_fn(x, sigma)
        return torch.clamp(v, -1.0, 1.0) if clip_denoised else v

    if sampler == "euler":
        return sample_euler_karras(denoiser, x_T, sigmas)
    if sampler == "heun":
        return sample_heun_karras(denoiser, x_T, sigmas, s_churn=s_churn, s_tmin=s_tmin,
                                  s_tmax=s_tmax, s_noise=s_noise, generator=generator)
    raise NotImplementedError(f"sampler {sampler!r} not implemented (the reference dispatch "
                              "table also only contains euler/heun; karras_sample.py:32-35)")


def odeint(func: Velocity, y0: torch.Tensor, t0: float = 1.0, t1: float = 0.0, *,
           method: str = "dopri5", rtol: float = 1e-5, atol: float = 1e-5,
           step_size: Optional[float] = None, num_steps: Optional[int] = None,
           max_steps: int = 10_000, eval_noise: EvalNoise = 0.0,
           record_trace: bool = False, group=None):
    """Integrate dy/dt = func(t, y) from t0 to t1 (sampling: 1 -> 0).
    ``func`` receives t as a 0-d tensor on y0's device. ``eval_noise``
    (adaptive only) is ``func``'s relative evaluation noise, a float, or
    ``"auto"`` to calibrate it at t0 (one evaluation more). ``group``
    (adaptive only): y0 is this rank's equal share of a batch split over
    the group's ranks, and the step control's norms are the whole batch's."""
    if method in ADAPTIVE_SOLVERS:
        return _odeint_adaptive(func, y0, t0, t1, method, rtol, atol, max_steps,
                                eval_noise=eval_noise, record_trace=record_trace,
                                group=group)
    if method in _FIXED_TABLEAUS:
        if num_steps is None:
            ss = step_size if step_size else 0.01
            num_steps = max(1, int(round(abs(t1 - t0) / ss)))
        return _odeint_fixed(func, y0, t0, t1, method, num_steps)
    raise NotImplementedError(f"unknown method {method!r}")
