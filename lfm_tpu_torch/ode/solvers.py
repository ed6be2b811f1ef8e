"""ODE solvers for flow-matching sampling (port of lfm_tpu/ode/solvers.py).

The JAX package runs these loops as ``lax.scan`` / ``lax.while_loop`` only
because XLA needs static control flow. Here the loop runs on the host, one
Python iteration per step; the velocity evaluations stay on the device.

* fixed-step solvers: euler, midpoint, heun, rk4;
* adaptive dopri5 with torchdiffeq's controller: the Hairer initial step,
  accept iff the RMS error ratio <= 1, step factor
  min(ifactor, max(safety * ratio^(-1/order), dfactor')) with safety=0.9,
  ifactor=10, dfactor=0.2 (dfactor'=1 after an accepted step), free
  stepping past t1 and the quartic dense-output fit evaluated at t1.

Controller arithmetic runs in float32, or in float64 when the state is
float64 (the JAX package's ``_acc``: f64 only under jax_enable_x64). The
state is one tensor. Karras samplers, bosh3, adaptive_heun, dopri8 and the
``eval_noise`` floor are not ported yet.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

ADAPTIVE_SOLVERS = ("dopri5",)
FIXED_SOLVERS = ("euler", "midpoint", "rk4", "heun")

Velocity = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class ODEResult(NamedTuple):
    y: torch.Tensor
    nfe: float  # number of function evaluations
    num_steps: int
    num_rejected: int


def _acc_dtype(y: torch.Tensor) -> torch.dtype:
    return torch.float64 if y.dtype == torch.float64 else torch.float32


def _combine(y0: torch.Tensor, ks: Sequence[torch.Tensor], coeffs, dt) -> torch.Tensor:
    """y0 + dt * sum_i coeffs[i] * ks[i], accumulated in the controller
    dtype, zero coefficients skipped (ode/solvers.py::_combine)."""
    acc_t = _acc_dtype(y0)
    acc = y0.to(acc_t)
    for c, k in zip(coeffs, ks):
        if c != 0.0:
            acc = acc + (dt * c) * k.to(acc_t)
    return acc.to(y0.dtype)


def _rms_norm(x: torch.Tensor, acc_t) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(x.to(acc_t))) / x.numel())


def _error_ratio(err, y0, y1, rtol, atol, acc_t) -> torch.Tensor:
    """RMS of err / (atol + rtol * max(|y0|, |y1|)): torchdiffeq's norm."""
    tol = atol + rtol * torch.maximum(y0.abs(), y1.abs()).to(acc_t)
    return torch.sqrt(torch.sum(torch.square(err.to(acc_t) / tol)) / err.numel())


# dopri5 Butcher tableau (public-domain coefficients) and torchdiffeq's
# DPS_C_MID midpoint weights for the dense-output fit
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B_ERR = (
    35 / 384 - 1951 / 21600, 0.0, 500 / 1113 - 22642 / 50085,
    125 / 192 - 451 / 720, -2187 / 6784 + 12231 / 42400,
    11 / 84 - 649 / 6300, -1 / 60,
)
_C_MID = (
    6025192743 / 30085553152 / 2, 0.0, 51252292925 / 65400821598 / 2,
    -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
    -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2,
)
_ORDER = 5


def _rk_step(func: Velocity, t, dt, y0, f0):
    """One dopri5 step. Returns (y1, f1, err, ks); FSAL: 6 new evaluations."""
    acc_t = _acc_dtype(y0)
    ks = [f0]
    for i in range(1, len(_C)):
        ks.append(func(t + _C[i] * dt, _combine(y0, ks, _A[i], dt)))
    y1 = _combine(y0, ks, _B, dt)
    err = None
    for c, k in zip(_B_ERR, ks):
        if c != 0.0:
            term = (dt * c) * k.to(acc_t)
            err = term if err is None else err + term
    return y1, ks[-1], err, ks


def _interp_fit(y0, y1, ks, dt) -> List[torch.Tensor]:
    """torchdiffeq's quartic dense-output fit (rk_common.py::_interp_fit),
    coefficients highest power first, in x = (t - t0) / dt."""
    acc_t = _acc_dtype(y0)
    y0f, y1f = y0.to(acc_t), y1.to(acc_t)
    mid = None
    for c, k in zip(_C_MID, ks):
        if c != 0.0:
            term = c * k.to(acc_t)
            mid = term if mid is None else mid + term
    ym = y0f + dt * mid
    f0 = dt * ks[0].to(acc_t)
    f1 = dt * ks[-1].to(acc_t)
    a = 2.0 * (f1 - f0) - 8.0 * (y1f + y0f) + 16.0 * ym
    b = 5.0 * f0 - 3.0 * f1 + 18.0 * y0f + 14.0 * y1f - 32.0 * ym
    c = f1 - 4.0 * f0 - 11.0 * y0f - 5.0 * y1f + 16.0 * ym
    return [a, b, c, f0, y0f]


def _initial_step(func, t0, y0, f0, order, rtol, atol, direction):
    """Hairer/Wanner initial-step heuristic (as in torchdiffeq and scipy)."""
    acc_t = _acc_dtype(y0)
    scale = atol + rtol * y0.to(acc_t).abs()
    d0 = _rms_norm(y0.to(acc_t) / scale, acc_t)
    d1 = _rms_norm(f0.to(acc_t) / scale, acc_t)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.ones_like(d0) * 1e-6,
                     0.01 * d0 / d1)
    y1 = y0 + (h0 * direction) * f0.to(y0.dtype)
    f1 = func(t0 + h0 * direction, y1)
    d2 = _rms_norm((f1 - f0).to(acc_t) / scale, acc_t) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / dmax) ** (1.0 / (order + 1)))
    return torch.minimum(100.0 * h0, h1)


def _odeint_adaptive(func: Velocity, y0: torch.Tensor, t0: float, t1: float,
                     method: str, rtol: float, atol: float, max_steps: int,
                     safety: float = 0.9, ifactor: float = 10.0,
                     dfactor: float = 0.2, record_trace: bool = False):
    """torchdiffeq-style dopri5. The final value is the quartic dense-output
    interpolant at t1 from the step that crosses it. With ``record_trace``
    also returns one (t, dt, accepted, error_ratio) row per attempted step."""
    if method != "dopri5":
        raise NotImplementedError(f"adaptive method {method!r} is not ported yet")
    acc_t = _acc_dtype(y0)
    dev = y0.device
    direction = 1.0 if t1 >= t0 else -1.0
    t = torch.tensor(t0, dtype=acc_t, device=dev)
    t1_t = torch.tensor(t1, dtype=acc_t, device=dev)

    f = func(t, y0)
    # torchdiffeq passes ``order - 1`` (rk_common.py): exponent 1/order
    dt = _initial_step(func, t, y0, f, _ORDER - 1, rtol, atol, direction) * direction
    nfe, steps, rejected = 2.0, 0, 0  # f0 + the initial-step probe
    y = y0
    coeffs, t_prev, h_prev = None, t, None
    trace = []

    while steps + rejected < max_steps:
        t_f = float(t)
        if not (abs(t_f - t1) > 1e-12 and (t_f - t1) * direction < 0):
            break
        y1, f1, err, ks = _rk_step(func, t, dt, y, f)
        ratio = _error_ratio(err, y, y1, rtol, atol, acc_t)
        ratio_f = float(ratio)
        accept = ratio_f <= 1.0
        if record_trace:
            trace.append((t_f, float(dt), accept, ratio_f))
        nfe += 6
        if ratio_f == 0.0:
            factor = torch.full_like(ratio, ifactor)
        else:
            dfac = 1.0 if ratio_f < 1.0 else dfactor
            factor = torch.clamp(torch.clamp(safety * ratio ** (-1.0 / _ORDER),
                                             min=dfac), max=ifactor)
        if accept:
            coeffs = _interp_fit(y, y1, ks, dt)
            t_prev, h_prev = t, dt
            t = t + dt
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
    res = ODEResult(y=y_out, nfe=nfe, num_steps=steps, num_rejected=rejected)
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


def odeint(func: Velocity, y0: torch.Tensor, t0: float = 1.0, t1: float = 0.0, *,
           method: str = "dopri5", rtol: float = 1e-5, atol: float = 1e-5,
           step_size: Optional[float] = None, num_steps: Optional[int] = None,
           max_steps: int = 10_000, record_trace: bool = False):
    """Integrate dy/dt = func(t, y) from t0 to t1 (sampling: 1 -> 0).
    ``func`` receives t as a 0-d tensor on y0's device."""
    if method in ADAPTIVE_SOLVERS:
        return _odeint_adaptive(func, y0, t0, t1, method, rtol, atol, max_steps,
                                record_trace=record_trace)
    if method in _FIXED_TABLEAUS:
        if num_steps is None:
            ss = step_size if step_size else 0.01
            num_steps = max(1, int(round(abs(t1 - t0) / ss)))
        return _odeint_fixed(func, y0, t0, t1, method, num_steps)
    raise NotImplementedError(f"method {method!r} is not ported yet")
