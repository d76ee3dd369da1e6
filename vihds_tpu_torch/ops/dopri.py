"""Adaptive embedded Runge-Kutta integrators: Dormand-Prince 5(4)
(``dopri5``), DOP853 (``dopri8``), Bogacki-Shampine 3(2) (``bosh3``) and
Heun-Euler 2(1) (``adaptive_heun``).

The counterpart of ``vihds_tpu.ops.dopri``, step for step.  Each observation
interval [t_i, t_{i+1}] is integrated on its own by a PI-controlled loop that
starts from the step size the previous interval ended with; the error norm is
the RMS over the whole batched state, so the step sequence is shared by every
row integrated together (inside a decoder block sharded over ranks, the
whole batch's: ``parallel.block_mean``).  The controller (the clip of each
step to the interval's end, the accept test, the step-size factor and its
floor) runs on the device as float32 tensors, as the JAX package's
``lax.while_loop`` does; the loop's exit is a host decision, one device sync
per attempted step.

With ``folds`` (``--vmap_folds``: the state's rows are the folds', fold-major)
every fold has a controller of its own, as ``jax.vmap`` of the JAX
integrator gives it (one loop serves both: without ``folds`` it runs one
fold): its time, step size and step count are ``[F]`` tensors,
its error norm the RMS over its own rows, and a fold that has finished its
interval (or reached the step cap) is held while the others go on: every
attempted step evaluates every fold, and each fold keeps the new carry only
while its own loop condition holds, as a batched ``lax.while_loop`` selects
it.  The right-hand side then sees each row's own time, a ``[R, 1, ...]``
tensor broadcastable against ``y[..., 0]``.

Each tableau is a float32 tensor on the state's device, and the stages are
combined with one ``tensordot`` over the stage axis (zeros for the stages
not yet evaluated), as the JAX package combines them.  DOP853's
coefficients come from ``scipy.integrate._ivp.dop853_coefficients``, with
scipy's 5th / 3rd-order error combination.
"""

import functools

import numpy as np
import torch

from vihds_tpu_torch import parallel

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


def _dot(w, ks):
    """The stages ``ks`` [n, ...] weighted by ``w`` [n] and summed."""
    return torch.tensordot(w, ks, dims=1)


def _stages(rhs, t, y, h, A, C, n_stages, dot=_dot):
    """Evaluate the first ``n_stages`` rows of ``A``; returns the stages
    stacked on a leading axis of A's rows (unevaluated rows zero)."""
    ks = torch.zeros((A.shape[0],) + y.shape, dtype=y.dtype, device=y.device)
    ks[0] = rhs(t, y)
    for i in range(1, n_stages):
        ks[i] = rhs(t + C[i] * h, y + h * dot(A[i], ks))
    return ks


def _erk_step(method, rhs, t, y, h, dot=_dot):
    """One embedded step of ``dopri5``, ``bosh3`` or ``adaptive_heun``:
    (y_new, error estimate)."""
    A, C, B, E = _tableau(method, y.device)
    ks = _stages(rhs, t, y, h, A, C, A.shape[0], dot)
    return y + h * dot(B, ks), h * dot(E, ks)


def _dop853_step(method, rhs, t, y, h, dot=_dot):
    """One DOP853 step with scipy's combined 5th / 3rd-order error."""
    A, C, B, E3, E5 = _tableau(method, y.device)
    n_rows = A.shape[0]
    ks = _stages(rhs, t, y, h, A, C, n_rows - 1, dot)
    y_new = y + h * dot(B, ks)
    ks[n_rows - 1] = rhs(t + h, y_new)
    err5 = h * dot(E5, ks)
    err3 = h * dot(E3, ks)
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


def _rms_norms(sq, folds):
    """sqrt(mean(sq)) per fold of ``sq``'s fold-major rows, [folds]: each
    fold's mean reduces its own contiguous rows, as a run on that fold alone
    reduces them.  One fold's mean is the whole batch's
    (``parallel.block_mean``: inside a decoder block sharded over ranks, the
    mean over every rank's block)."""
    if folds == 1:
        return torch.sqrt(parallel.block_mean(sq)).reshape(1)
    flat = sq.reshape(folds, -1)
    return torch.sqrt(torch.stack([torch.mean(flat[f]) for f in range(folds)]))


def _attempt(y, y_new, err, rtol, atol, inv_order, folds):
    """The controller's reading of an attempted step: (accept, the factor on
    its step size), each [folds]."""
    safety, min_factor, max_factor = 0.9, 0.2, 10.0
    scale = atol + rtol * torch.maximum(y.abs(), y_new.abs())
    en = _rms_norms((err / scale) ** 2, folds)
    factor = torch.clamp(
        safety * torch.pow(torch.clamp(en, min=1e-10), -inv_order), min_factor, max_factor
    )
    return en <= 1.0, factor


def integrate_adaptive(rhs, y0, times, method="dopri5", rtol=1e-6, atol=1e-8,
                       max_steps_per_interval=None, folds=None, stats=None):
    """Integrate ``y' = rhs(t, y)`` to each grid time exactly; returns
    [T, *y0.shape] with y0 at index 0.  ``times`` is a float32 tensor on
    y0's device.  ``folds``: the number of folds whose rows (fold-major)
    make up y0, each stepped by its own controller (see the module's
    docstring); None is one.  ``stats``: a dict that receives the attempted
    and the accepted steps of each interval, ``[T - 1]`` tensors (``[T - 1,
    F]`` with folds)."""
    stepper = _STEPPERS[method]
    inv_order = 1.0 / ORDERS[method]
    max_steps = max_steps_per_interval
    if max_steps is None:
        max_steps = max_steps_default(method)
    n_folds = folds or 1
    n_rows = y0.shape[0]
    if n_rows % n_folds:
        raise ValueError("%d rows do not split into %d folds" % (n_rows, n_folds))
    per_fold = n_rows // n_folds
    row_shape = (n_rows,) + (1,) * (y0.dim() - 1)

    if n_folds == 1:
        # one controller: the steps take its time and step size as scalars
        def rows(v):
            return v[0]

        fold_rhs, fold_dot = rhs, _dot
    else:
        def rows(v):
            """A per-fold [F] tensor on each fold's rows, broadcastable against y."""
            return v.repeat_interleave(per_fold).reshape(row_shape)

        def fold_rhs(t, y):
            # the stepper forms each stage's time as a y-shaped column; the
            # right-hand side takes it against y[..., 0]
            return rhs(t[..., 0], y)

        def fold_dot(w, ks):
            # each fold's stages summed on their own, as a run on that fold
            # alone sums them (a product over all rows may round otherwise)
            return torch.cat([torch.tensordot(w, ks[:, f * per_fold:(f + 1) * per_fold], dims=1)
                              for f in range(n_folds)])

    ys = [y0]
    y = y0
    dt = ((times[1] - times[0]) * 0.5).expand(n_folds)
    attempted, accepted = [], []
    for i in range(times.shape[0] - 1):
        t_end = times[i + 1]
        t = times[i].expand(n_folds)
        span = t_end - times[i]
        t_stop = t_end - 1e-12
        dt = torch.minimum(dt, span)
        steps = torch.zeros(n_folds, dtype=torch.int64, device=y0.device)
        n_accept = torch.zeros_like(steps)
        # a batched lax.while_loop: every fold steps, and a fold keeps the
        # new carry only while its own condition holds.  A fold that stops
        # stays stopped, so every fold still going has taken every attempt
        # so far, and the step cap stops them all at once.
        for _ in range(max_steps):
            active = t < t_stop
            if not bool(active.any() if n_folds > 1 else active):
                break
            h = torch.minimum(dt, t_end - t)
            y_new, err = stepper(method, fold_rhs, rows(t), y, rows(h), fold_dot)
            accept, factor = _attempt(y, y_new, err, rtol, atol, inv_order, n_folds)
            dt_new = torch.maximum(h * factor, span * 1e-4)
            if n_folds > 1:
                accept = active & accept
                dt_new = torch.where(active, dt_new, dt)
            dt = dt_new
            t = torch.where(accept, t + h, t)
            y = torch.where(rows(accept), y_new, y)
            if stats is not None:
                steps = steps + active
                n_accept = n_accept + accept
        ys.append(y)
        attempted.append(steps)
        accepted.append(n_accept)
    if stats is not None:
        shape = (-1,) if folds is None else (-1, n_folds)
        stats["attempted"] = torch.stack(attempted).reshape(shape).cpu()
        stats["accepted"] = torch.stack(accepted).reshape(shape).cpu()
    return torch.stack(ys, dim=0)
