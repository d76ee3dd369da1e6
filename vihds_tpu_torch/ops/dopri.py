"""Adaptive embedded Runge-Kutta integrators: Dormand-Prince 5(4)
(``dopri5``), DOP853 (``dopri8``), Bogacki-Shampine 3(2) (``bosh3``) and
Heun-Euler 2(1) (``adaptive_heun``).

The counterpart of ``vihds_tpu.ops.dopri``, step for step.  Each observation
interval [t_i, t_{i+1}] is integrated on its own by a PI-controlled loop that
starts from the step size the previous interval ended with; the error norm is
the RMS over the whole batched state, so the step sequence is shared by every
row integrated together.  The controller (the clip of each step to the
interval's end, the accept test, the step-size factor and its floor) runs on
the device as float32 tensors, as the JAX package's ``lax.while_loop`` does;
the loop's exit is a host decision, one device sync per attempted step.

Each tableau is a float32 tensor on the state's device, and the stages are
combined with one ``tensordot`` over the stage axis (zeros for the stages
not yet evaluated), as the JAX package combines them.  DOP853's
coefficients come from ``scipy.integrate._ivp.dop853_coefficients``, with
scipy's 5th / 3rd-order error combination.
"""

import functools

import numpy as np
import torch

# Dormand-Prince 5(4)
_DP5_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DP5_A = np.zeros((7, 7))
_DP5_A[1, 0] = 1 / 5
_DP5_A[2, :2] = [3 / 40, 9 / 40]
_DP5_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_DP5_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_DP5_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
_DP5_A[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_DP5_B = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_DP5_BHAT = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)

# Bogacki-Shampine 3(2)
_BS3_C = np.array([0.0, 1 / 2, 3 / 4, 1.0])
_BS3_A = np.zeros((4, 4))
_BS3_A[1, 0] = 1 / 2
_BS3_A[2, :2] = [0.0, 3 / 4]
_BS3_A[3, :3] = [2 / 9, 1 / 3, 4 / 9]
_BS3_B = np.array([2 / 9, 1 / 3, 4 / 9, 0.0])
_BS3_BHAT = np.array([7 / 24, 1 / 4, 1 / 3, 1 / 8])

# Heun-Euler 2(1)
_HE2_C = np.array([0.0, 1.0])
_HE2_A = np.zeros((2, 2))
_HE2_A[1, 0] = 1.0
_HE2_B = np.array([1 / 2, 1 / 2])
_HE2_BHAT = np.array([1.0, 0.0])


def _dop853_tables():
    """(A, C, B, E3, E5): scipy's 12 stages and the 13th row, f(t + h,
    y_new), that the error estimate takes."""
    from scipy.integrate._ivp import dop853_coefficients as d

    n = d.N_STAGES  # 12
    B = np.zeros(n + 1)
    B[:n] = d.B
    return d.A[: n + 1, : n + 1].copy(), d.C[: n + 1].copy(), B, d.E3.copy(), d.E5.copy()


_TABLES = {
    "dopri5": lambda: (_DP5_A, _DP5_C, _DP5_B, _DP5_B - _DP5_BHAT),
    "bosh3": lambda: (_BS3_A, _BS3_C, _BS3_B, _BS3_B - _BS3_BHAT),
    "adaptive_heun": lambda: (_HE2_A, _HE2_C, _HE2_B, _HE2_B - _HE2_BHAT),
    "dopri8": _dop853_tables,
}

#: method -> the order the step-size controller takes
ORDERS = {"dopri5": 5, "dopri8": 8, "bosh3": 3, "adaptive_heun": 2}


@functools.lru_cache(maxsize=None)
def _tableau(method, device):
    """The method's tableau as float32 tensors on ``device``."""
    return tuple(torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
                 for x in _TABLES[method]())


def _stages(rhs, t, y, h, A, C, n_stages):
    """Evaluate the first ``n_stages`` rows of ``A``; returns the stages
    stacked on a leading axis of A's rows (unevaluated rows zero)."""
    ks = torch.zeros((A.shape[0],) + y.shape, dtype=y.dtype, device=y.device)
    ks[0] = rhs(t, y)
    for i in range(1, n_stages):
        ks[i] = rhs(t + C[i] * h, y + h * torch.tensordot(A[i], ks, dims=1))
    return ks


def _erk_step(method, rhs, t, y, h):
    """One embedded step of ``dopri5``, ``bosh3`` or ``adaptive_heun``:
    (y_new, error estimate)."""
    A, C, B, E = _tableau(method, y.device)
    ks = _stages(rhs, t, y, h, A, C, A.shape[0])
    return y + h * torch.tensordot(B, ks, dims=1), h * torch.tensordot(E, ks, dims=1)


def _dop853_step(method, rhs, t, y, h):
    """One DOP853 step with scipy's combined 5th / 3rd-order error."""
    A, C, B, E3, E5 = _tableau(method, y.device)
    n_rows = A.shape[0]
    ks = _stages(rhs, t, y, h, A, C, n_rows - 1)
    y_new = y + h * torch.tensordot(B, ks, dims=1)
    ks[n_rows - 1] = rhs(t + h, y_new)
    err5 = h * torch.tensordot(E5, ks, dims=1)
    err3 = h * torch.tensordot(E3, ks, dims=1)
    denom = torch.hypot(err5.abs(), 0.1 * err3.abs())
    correction = torch.where(denom > 0, err5.abs() / torch.clamp(denom, min=1e-30),
                             torch.ones_like(denom))
    return y_new, err5 * correction


_STEPPERS = {"dopri5": _erk_step, "dopri8": _dop853_step, "bosh3": _erk_step,
             "adaptive_heun": _erk_step}


def max_steps_default(method):
    """The per-interval cap on attempted steps: generous enough for the
    method's order at the default tolerances (an order-2 method needs far
    more steps than an order-5 one)."""
    return {2: 2048, 3: 512}.get(ORDERS[method], 64)


def integrate_adaptive(rhs, y0, times, method="dopri5", rtol=1e-6, atol=1e-8,
                       max_steps_per_interval=None):
    """Integrate ``y' = rhs(t, y)`` to each grid time exactly; returns
    [T, *y0.shape] with y0 at index 0.  ``times`` is a float32 tensor on
    y0's device."""
    stepper = _STEPPERS[method]
    inv_order = 1.0 / ORDERS[method]
    if max_steps_per_interval is None:
        max_steps_per_interval = max_steps_default(method)
    safety, min_factor, max_factor = 0.9, 0.2, 10.0

    ys = [y0]
    y = y0
    dt = (times[1] - times[0]) * 0.5
    for i in range(times.shape[0] - 1):
        t, t_end = times[i], times[i + 1]
        span = t_end - t
        t_stop = t_end - 1e-12
        dt = torch.minimum(dt, span)
        steps = 0
        while steps < max_steps_per_interval and bool(t < t_stop):
            h = torch.minimum(dt, t_end - t)
            y_new, err = stepper(method, rhs, t, y, h)
            scale = atol + rtol * torch.maximum(y.abs(), y_new.abs())
            en = torch.sqrt(torch.mean((err / scale) ** 2))
            accept = en <= 1.0
            factor = torch.clamp(
                safety * torch.pow(torch.clamp(en, min=1e-10), -inv_order), min_factor, max_factor
            )
            dt = torch.maximum(h * factor, span * 1e-4)
            t = torch.where(accept, t + h, t)
            y = torch.where(accept, y_new, y)
            steps += 1
        ys.append(y)
    return torch.stack(ys, dim=0)
