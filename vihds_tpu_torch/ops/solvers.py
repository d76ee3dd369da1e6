"""Fixed-grid ODE integrators as plain Python loops over the time grid.

The counterpart of ``vihds_tpu.ops.solvers.integrate_fixed`` (a ``lax.scan``
there).  This is the generic path for any model RHS; ``dr_constant`` under
``solver: pallas_<method>`` takes the fused CUDA kernels instead
(``vihds_tpu_torch.ops.fused_ode``).  ``integrate_fixed`` returns
[T, *y0.shape] with the initial state at index 0; ``integrate_fold`` is the
training objective's form, which never keeps the trajectory.  ``integrate``
routes the adaptive methods (``ops.dopri``) and ``adjoint_solver: true``
through the continuous adjoint (``ops.adjoint``).
"""

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint


def _step_modeuler(rhs, y, t1, t2, h):
    """Modified-Euler / Heun."""
    f1 = rhs(t1, y)
    f2 = rhs(t2, y + h * f1)
    return y + 0.5 * h * (f1 + f2)


def _step_midpoint(rhs, y, t1, t2, h):
    f1 = rhs(t1, y)
    f2 = rhs(t1 + 0.5 * h, y + 0.5 * h * f1)
    return y + h * f2


def _step_euler(rhs, y, t1, t2, h):
    return y + h * rhs(t1, y)


def _step_rk4(rhs, y, t1, t2, h):
    k1 = rhs(t1, y)
    k2 = rhs(t1 + 0.5 * h, y + 0.5 * h * k1)
    k3 = rhs(t1 + 0.5 * h, y + 0.5 * h * k2)
    k4 = rhs(t2, y + h * k3)
    return y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


FIXED_GRID_SOLVERS = {
    "modeuler": _step_modeuler,
    "modeulerwhile": _step_modeuler,
    "midpoint": _step_midpoint,
    "euler": _step_euler,
    "rk4": _step_rk4,
}

ADAPTIVE_SOLVERS = ("dopri5", "dopri8", "bosh3", "adaptive_heun")


def integrate_fixed(rhs, y0, times, method="midpoint"):
    """Step the chosen one-step method over the (possibly non-uniform) grid."""
    step_fn = FIXED_GRID_SOLVERS[method]
    ys = [y0]
    y = y0
    for i in range(times.shape[0] - 1):
        t1, t2 = times[i], times[i + 1]
        y = step_fn(rhs, y, t1, t2, t2 - t1)
        ys.append(y)
    return torch.stack(ys, dim=0)


def integrate_fold(rhs, y0, times, fold, xs, method="midpoint"):
    """Integrate WITHOUT keeping the trajectory: after every step the
    per-time term ``fold(y_t, xs[t])`` is added to a running sum (the t=0
    term is taken before the loop).  ``xs`` is a tensor with leading axis T.
    Returns ``(y_final, sum_t fold(y_t, xs[t]))``.

    Each step (and its fold) is recomputed in the backward pass with
    ``torch.utils.checkpoint`` instead of storing its intermediates, the
    counterpart of ``jax.checkpoint`` on the scan body of
    ``vihds_tpu.ops.solvers.integrate_fold``.  Fixed-grid methods only."""
    step_fn = FIXED_GRID_SOLVERS[method]

    def step(y, acc, t1, t2, x_t):
        y_new = step_fn(rhs, y, t1, t2, t2 - t1)
        return y_new, acc + fold(y_new, x_t)

    y = y0
    acc = fold(y0, xs[0])
    for i in range(times.shape[0] - 1):
        y, acc = _checkpoint(step, y, acc, times[i], times[i + 1], xs[i + 1], use_reentrant=False)
    return y, acc


def integrate(rhs, y0, times, method="midpoint", adjoint=False, folds=None, **opts):
    """Integrate and return [T, *y0.shape].  ``rhs`` is the right-hand side
    ``f(t, y)`` or, where the continuous adjoint may be taken, ``(make_rhs,
    args)``, which builds it (``ops.adjoint.integrate_adjoint``).

    An adaptive method always goes through the adjoint, with ``opts``
    (rtol, atol, max_steps_per_interval) and ``folds`` (a step controller
    per fold of y0's fold-major rows) forwarded to its integrator;
    ``adjoint=True`` sends a fixed-grid method through it as well (a
    fixed grid needs no fold count: every row steps alike)."""
    if method in ADAPTIVE_SOLVERS or (adjoint and method in FIXED_GRID_SOLVERS):
        from vihds_tpu_torch.ops.adjoint import integrate_adjoint

        if method in ADAPTIVE_SOLVERS and folds is not None:
            opts = dict(opts, folds=folds)
        return integrate_adjoint(rhs, y0, times, method=method,
                                 **(opts if method in ADAPTIVE_SOLVERS else {}))
    if method not in FIXED_GRID_SOLVERS:
        raise ValueError(
            "Unknown solver %r; supported: %s (fixed-grid) and %s (adaptive). "
            "torchdiffeq's Adams family and tsit5 are deliberately excluded — "
            "see PARITY.md's solver row." % (
                method, sorted(FIXED_GRID_SOLVERS), list(ADAPTIVE_SOLVERS),
            )
        )
    if not callable(rhs):
        make_rhs, args = rhs
        rhs = make_rhs(*args)
    return integrate_fixed(rhs, y0, times, method=method)
