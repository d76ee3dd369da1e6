"""Differentiation through an ODE solve by the continuous adjoint.

The counterpart of ``vihds_tpu.ops.adjoint``.  The forward pass is the
adaptive integrator (``ops.dopri``) for an adaptive method, or the fixed-grid
``integrate_fixed``; it keeps only the grid states ``ys``.  The backward pass
integrates the augmented system (y, a, c_bar) from the last grid time to the
first, interval by interval, on ``n_sub`` classic RK4 substeps, re-anchoring
y at the stored grid state at the start of each interval and adding the
output's cotangent at each grid time to a.

The right-hand side is a closure over tensors that carry gradient (theta, the
decoder's nets).  An autograd Function passes gradient back to its inputs
only, so the caller hands the closure's *builder* and its arguments,
``(make_rhs, args)``: ``args`` (dicts, lists and tuples of tensors) are
flattened into inputs of the Function, and the closure is rebuilt from them
in the forward and, from copies that require grad, in the backward, where
each vector-Jacobian product pulls ``a`` back to y and to every tensor the
closure reaches.  This is what ``jax.closure_convert`` does in the JAX
package.
"""

import types

import torch

from vihds_tpu_torch.ops import dopri
from vihds_tpu_torch.ops.solvers import ADAPTIVE_SOLVERS, integrate_fixed


def _flatten(tree, leaves):
    """The tensors of ``tree`` appended to ``leaves``; returns the tree's
    skeleton, with each tensor replaced by its index."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _Leaf(len(leaves) - 1)
    if isinstance(tree, dict):
        return type(tree)((k, _flatten(v, leaves)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    return tree


class _Leaf:
    def __init__(self, index):
        self.index = index


def _unflatten(skeleton, leaves):
    if isinstance(skeleton, _Leaf):
        return leaves[skeleton.index]
    if isinstance(skeleton, dict):
        return type(skeleton)((k, _unflatten(v, leaves)) for k, v in skeleton.items())
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_unflatten(v, leaves) for v in skeleton)
    return skeleton


def _forward(rhs, y0, times, method, opts):
    if method in ADAPTIVE_SOLVERS:
        return dopri.integrate_adaptive(rhs, y0, times, method=method, **opts)
    return integrate_fixed(rhs, y0, times, method=method)


class _Adjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, make_rhs, skeleton, method, n_sub, opts, y0, times, *leaves):
        ys = _forward(make_rhs(*_unflatten(skeleton, leaves)), y0, times, method, opts)
        ctx.save_for_backward(ys, times, *leaves)
        ctx.make_rhs, ctx.skeleton, ctx.n_sub = make_rhs, skeleton, n_sub
        return ys

    @staticmethod
    def backward(ctx, g):
        ys, times, *leaves = ctx.saved_tensors
        needs = ctx.needs_input_grad[7:]
        wanted = [i for i, need in enumerate(needs) if need]
        with torch.enable_grad():
            copies = [leaf.detach().requires_grad_(True) if need else leaf.detach()
                      for leaf, need in zip(leaves, needs)]
            rhs, hoisted, originals = _closure_convert(
                ctx.make_rhs(*_unflatten(ctx.skeleton, copies)))
            # what the right-hand side reaches: its hoisted constants and,
            # where a path bypasses them, the arguments themselves (one probe:
            # the graph's shape is the same at every evaluation)
            y_ = ys[-1].detach().requires_grad_(True)
            f = rhs(times[-1], y_)
            candidates = hoisted + [copies[i] for i in wanted]
            reach = torch.autograd.grad(f, candidates, torch.ones_like(f), retain_graph=True,
                                        allow_unused=True) if candidates else []
            consts = [c for c, r in zip(candidates, reach) if r is not None]

            def aug_rhs(t, y, a):
                """(f, -a df/dy, a df/dc) at (t, y): the y and a parts of
                the augmented system's derivative (the backward-in-time
                sign of a folds into the negative step) and the constants'
                vector-Jacobian products."""
                y_ = y.detach().requires_grad_(True)
                f = rhs(t, y_)
                got = torch.autograd.grad(f, [y_] + consts, a, retain_graph=True,
                                          allow_unused=True)
                return (f.detach(), _neg(got[0], y),
                        [torch.zeros_like(c) if d is None else d
                         for d, c in zip(got[1:], consts)])

            T = ys.shape[0]
            a = g[T - 1]
            cbar = [torch.zeros_like(c) for c in consts]
            for i in range(T - 1, 0, -1):
                a, cbar = _rk4_sub(aug_rhs, ys[i], a, cbar, times[i], times[i - 1], ctx.n_sub)
                a = a + g[i - 1]

            # the constants' cotangents back to the arguments, once
            by_id = {id(c): v for c, v in zip(consts, cbar)}
            outs = [(o, by_id[id(h)]) for h, o in zip(hoisted, originals) if id(h) in by_id]
            outs += [(c, by_id[id(c)]) for c in (copies[i] for i in wanted) if id(c) in by_id]
            pulled = [None] * len(wanted)
            if outs and wanted:
                pulled = torch.autograd.grad([o for o, _ in outs], [copies[i] for i in wanted],
                                             [v for _, v in outs], allow_unused=True)
        grads = [None] * len(leaves)
        for i, d in zip(wanted, pulled):
            grads[i] = d
        # no gradient with respect to the time grid
        t_grad = torch.zeros_like(times) if ctx.needs_input_grad[6] else None
        return (None, None, None, None, None, a, t_grad) + tuple(grads)


def _closure_convert(rhs):
    """(rhs', hoisted, originals): ``rhs`` with every tensor that requires
    grad in its closure's cells (nested in dicts, lists and tuples) replaced
    by a detached copy that requires grad (``hoisted``, beside the tensor it
    replaces in ``originals``), as ``jax.closure_convert`` hoists a
    closure's traced constants.  Each vector-Jacobian product then stops at
    the hoisted constants, and their cotangents are pulled back through
    ``make_rhs`` once."""
    hoisted, originals, seen = [], [], {}

    def convert(x):
        if isinstance(x, torch.Tensor):
            if not x.requires_grad:
                return x
            if id(x) not in seen:
                seen[id(x)] = x.detach().requires_grad_(True)
                hoisted.append(seen[id(x)])
                originals.append(x)
            return seen[id(x)]
        if isinstance(x, dict):
            return type(x)((k, convert(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(convert(v) for v in x)
        return x

    if not rhs.__closure__:
        return rhs, hoisted, originals
    cells = tuple(types.CellType(convert(cell.cell_contents)) for cell in rhs.__closure__)
    converted = types.FunctionType(rhs.__code__, rhs.__globals__, rhs.__name__,
                                   rhs.__defaults__, cells)
    return converted, hoisted, originals


def _neg(d, like):
    """-d, where autograd's None (the output does not reach ``like``) is a
    zero."""
    return torch.zeros_like(like) if d is None else -d


def _rk4_sum(k1, k2, k3, k4):
    return (k1 + 2 * k2 + 2 * k3 + k4) / 6.0


def _rk4_sub(aug_rhs, y, a, cbar, t1, t0, n_sub):
    """``n_sub`` classic RK4 steps from t1 down to t0 on the augmented
    state (y, a, cbar); returns (a, cbar).  y and a step as in the JAX
    package (``_axpy`` of ``vihds_tpu.ops.adjoint``).  No stage reads cbar,
    so it takes only each step's weighted sum, through multi-tensor
    (``torch._foreach_*``) operations: cbar - h (v1 + 2 v2 + 2 v3 + v4) / 6
    for the stages' vector-Jacobian products v (the textbook adjoint's
    dcbar/dt = -a df/dc, stepped with negative h)."""
    h = (t0 - t1) / n_sub  # negative
    h_host = float(h)
    for i in range(n_sub):
        t = t1 + i * h
        f1, g1, v1 = aug_rhs(t, y, a)
        f2, g2, v2 = aug_rhs(t + 0.5 * h, y + 0.5 * h * f1, a + 0.5 * h * g1)
        f3, g3, v3 = aug_rhs(t + 0.5 * h, y + 0.5 * h * f2, a + 0.5 * h * g2)
        f4, g4, v4 = aug_rhs(t + h, y + h * f3, a + h * g3)
        y = y + h * _rk4_sum(f1, f2, f3, f4)
        a = a + h * _rk4_sum(g1, g2, g3, g4)
        if cbar:
            incr = torch._foreach_add(v1, v2, alpha=2)
            torch._foreach_add_(incr, v3, alpha=2)
            torch._foreach_add_(incr, v4)
            torch._foreach_div_(incr, 6.0)
            torch._foreach_add_(cbar, incr, alpha=-h_host)
    return a, cbar


def integrate_adjoint(rhs, y0, times, method="midpoint", n_sub=4, **opts):
    """Integrate and return [T, *y0.shape]; the gradient is the continuous
    adjoint's.  ``rhs`` is ``(make_rhs, args)``: ``make_rhs(*args)`` builds
    the right-hand side ``f(t, y)``, and every tensor in ``args`` (nested in
    dicts, lists and tuples) receives its gradient.  ``method`` is a
    fixed-grid method or an adaptive one; ``opts`` (rtol, atol,
    max_steps_per_interval) go to the adaptive integrator."""
    if callable(rhs) or len(rhs) != 2:
        raise TypeError(
            "the adjoint route takes the right-hand side as (make_rhs, args), so that "
            "gradient reaches the tensors the right-hand side closes over"
        )
    make_rhs, args = rhs
    leaves = []
    skeleton = _flatten(tuple(args), leaves)
    return _Adjoint.apply(make_rhs, skeleton, method, n_sub, dict(opts), y0, times, *leaves)
