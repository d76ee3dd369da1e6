"""Fused integration of the black-box ODE: the port's counterpart of
``vihds_tpu/ops/pallas_blackbox.py``.

The right-hand side of ``models/dr_blackbox.py`` is two small nets whose
weights every sample row shares (``NeuralStates`` over [x, c] and
``NeuralPrecisions`` with a relu hidden layer over [t, x, c]):

    h  = relu(W_h^T [x; c] + b_h),    dx = sigmoid(W_p^T h + b_p) - sigmoid(W_d^T h + b_d) x
    hp = relu(Wp_h^T [t; x; c] + bp_h), dv = sigmoid(Wp_p^T hp + bp_p) - sigmoid(Wp_d^T hp + bp_d) v

with x the ``n_states`` ODE states the nets model, v the 4 precision
states and c the row's constants.  Both directions are ported as
hand-written CUDA kernels, ``csrc/blackbox_fwd.cu`` and
``csrc/blackbox_bwd.cu`` (the TPU kernel's ``_make_kernel`` and
``_make_bwd_kernel``), built for the shipped ``dr_blackbox_icml`` widths
(``KERNEL_LEAF_SHAPES``).  ``_BlackboxIntegrate`` is the
``torch.autograd.Function`` over the packed ``[1760]`` weights, ``[NC, R]``
constants and ``[S, R]`` initial states: on a CUDA tensor it launches the
kernels or raises, on a CPU tensor it runs the plain versions
(``_plain_fwd``, ``_plain_bwd``), whose arithmetic the kernels repeat.

This is a module of its own, not a kind of ``fused_ode.KINDS``: the
mechanistic kinds carry per-row constants only, this one shares its weights.
Leaves with a fold axis (``[F, ...]``, one set of nets a fold, the TPU
kernels' grid axis under ``jax.vmap``) pack into ``[F, 1760]`` weights; the
rows are then F folds', fold-major, and each kernel runs every fold on its
own weights in one launch.
"""

import ctypes

import torch

from vihds_tpu_torch.ops import build, fused_ode

#: precision states after the ODE states
N_PREC = fused_ode.N_PREC
#: fixed order of the weight operands, each ``[n_in, n_out]`` / ``[n_out]``
#: (the JAX package's ``pallas_blackbox.WEIGHT_LEAVES``); the kernels take
#: them flattened row-major and concatenated in this order
WEIGHT_LEAVES = (
    ("states", "hidden", "w"),
    ("states", "hidden", "b"),
    ("states", "prod", "w"),
    ("states", "prod", "b"),
    ("states", "degr", "w"),
    ("states", "degr", "b"),
    ("precisions", "hidden", "w"),
    ("precisions", "hidden", "b"),
    ("precisions", "prod", "w"),
    ("precisions", "prod", "b"),
    ("precisions", "degr", "w"),
    ("precisions", "degr", "b"),
)
#: the widths csrc/blackbox_common.cuh is compiled for: specs/dr_blackbox_icml.yaml
#: (6 ODE states = 4 observed + 2 latent species; 21 constants = 12 latents,
#: 2 treatments, 7 device entries; hidden widths 25 and 20)
KERNEL_N_STATES = 6
KERNEL_N_CONST = 21


def leaf_shapes(n_states, n_const, n_hidden, n_hidden_prec):
    """The shapes of the 12 ``WEIGHT_LEAVES`` for these widths."""
    n_in = n_states + n_const
    return (
        (n_in, n_hidden), (n_hidden,),
        (n_hidden, n_states), (n_states,),
        (n_hidden, n_states), (n_states,),
        (1 + n_in, n_hidden_prec), (n_hidden_prec,),
        (n_hidden_prec, N_PREC), (N_PREC,),
        (n_hidden_prec, N_PREC), (N_PREC,),
    )


KERNEL_LEAF_SHAPES = leaf_shapes(KERNEL_N_STATES, KERNEL_N_CONST, 25, 20)
#: floats of the packed weight operand (1,760 at the kernels' widths)
KERNEL_N_W = sum(torch.Size(s).numel() for s in KERNEL_LEAF_SHAPES)
#: sample rows per block of the backward kernel (csrc/blackbox_common.cuh's
#: BWD_ROWS; each row is worked on by 8 threads): it returns the weight
#: cotangent as one partial sum per block
BWD_ROWS = 32
#: sample rows per block of the forward kernel (the header's FWD_ROWS, the
#: backward's block)
FWD_ROWS = 32


def supported(ode_model):
    """True when the kernels cover this ``DR_Blackbox``: NeuralStates with a
    hidden layer, NeuralPrecisions with a hidden relu layer, non-inverse, 4
    outputs (the JAX package's gate), at the widths the kernels are compiled
    for.  Any other configuration takes the same fixed-grid method on the
    generic solver; this is a choice of configuration, made before any
    launch, on every device."""
    p, ns = ode_model.precisions, ode_model.neural_states
    return (
        ns.n_hidden >= 1
        and p.n_hidden >= 1
        and not p.inverse
        and p.activation is torch.relu
        and p.n_outputs == N_PREC
        and leaf_shapes(ns.n_states, ns.n_inputs - ns.n_states, ns.n_hidden, p.n_hidden)
        == KERNEL_LEAF_SHAPES
    )


# --------------------------------------------------------------------------- #
# Plain PyTorch version
# --------------------------------------------------------------------------- #
def _t_row(t, y):
    return torch.broadcast_to(torch.as_tensor(t, dtype=y.dtype, device=y.device), y[:1].shape)


def _affine(w, b, x):
    """[n_in, n_out] weights and [n_out] bias on [n_in, R] columns -> [n_out, R]."""
    return w.t() @ x + b[:, None]


def _bb_rhs_cols(wv, consts, n_states, t, y):
    """The black-box right-hand side on [S, R] columns (S = n_states + 4),
    ``wv`` the 12 leaves in ``WEIGHT_LEAVES`` order, ``consts`` [NC, R]: the
    TPU kernel's ``_bb_rhs_cols``; csrc/blackbox_common.cuh's ``BbRhs``."""
    sh_w, sh_b, sp_w, sp_b, sd_w, sd_b, ph_w, ph_b, pp_w, pp_b, pd_w, pd_b = wv
    x = y[:n_states]
    h = torch.relu(_affine(sh_w, sh_b, torch.cat([x, consts])))
    dx = torch.sigmoid(_affine(sp_w, sp_b, h)) - torch.sigmoid(_affine(sd_w, sd_b, h)) * x
    hp = torch.relu(_affine(ph_w, ph_b, torch.cat([_t_row(t, y), x, consts])))
    dv = torch.sigmoid(_affine(pp_w, pp_b, hp)) - torch.sigmoid(_affine(pd_w, pd_b, hp)) * y[
        n_states:]
    return torch.cat([dx, dv])


def _relu_live(h):
    return h > 0


def _net_vjp(w_h, b_h, w_p, b_p, w_d, b_d, inp, v, cot, relu_mask=_relu_live):
    """Pullback of one net ``sigmoid(W_p^T h + b_p) - sigmoid(W_d^T h + b_d)
    v`` with h = relu(W_h^T inp + b_h), for the cotangent ``cot`` of its
    output.  With sp, sd the two sigmoids:

    * v gets -cot sd;
    * dap = cot sp (1 - sp), dad = -cot v sd (1 - sd);
    * dh = W_p dap + W_d dad, dah = dh where h > 0 (relu passes nothing at 0;
      ``relu_mask(h)`` gives that mask, see ``_plain_bwd``);
    * d inp = W_h dah.

    Returns (d inp, dv, the six leaves' cotangents summed over the rows)."""
    h = torch.relu(_affine(w_h, b_h, inp))
    sp = torch.sigmoid(_affine(w_p, b_p, h))
    sd = torch.sigmoid(_affine(w_d, b_d, h))
    dap = cot * sp * (1.0 - sp)
    dad = -cot * v * sd * (1.0 - sd)
    dah = torch.where(relu_mask(h), w_p @ dap + w_d @ dad, torch.zeros_like(h))
    dleaves = (inp @ dah.t(), dah.sum(dim=1), h @ dap.t(), dap.sum(dim=1), h @ dad.t(),
               dad.sum(dim=1))
    return w_h @ dah, -cot * sd, dleaves


def _bb_rhs_vjp_cols(wv, consts, n_states, t, y, w, acc):
    """Pullback of ``_bb_rhs_cols`` at (t, y) for the cotangent ``w`` [S, R]
    of its output.  Returns (df/dy)^T w [S, R]; adds the constants' share into
    ``acc["c"]`` [NC, R] and the 12 leaves' shares, summed over the rows, into
    ``acc["w"]``.  Hand-derived (``_net_vjp`` per net); csrc/blackbox_common.cuh's
    ``BbVjp`` repeats it per row and reduces the weights' share over the rows
    of a block.  The time input gets no cotangent."""
    ns = n_states
    x = y[:ns]
    mask = acc.get("relu_mask", _relu_live)
    d_aug, d_x, dl_s = _net_vjp(*wv[:6], torch.cat([x, consts]), x, w[:ns], mask)
    d_pin, d_v, dl_p = _net_vjp(*wv[6:], torch.cat([_t_row(t, y), x, consts]), y[ns:], w[ns:],
                                mask)
    acc["c"] = acc["c"] + (d_aug[ns:] + d_pin[1 + ns:])
    acc["w"] = [a + d for a, d in zip(acc["w"], dl_s + dl_p)]
    return torch.cat([d_x + d_aug[:ns] + d_pin[1:1 + ns], d_v])


def _rhs(c, t, y):
    wv, consts, n_states = c
    return _bb_rhs_cols(wv, consts, n_states, t, y)


def _vjp(c, t, y, w, acc):
    wv, consts, n_states = c
    return _bb_rhs_vjp_cols(wv, consts, n_states, t, y, w, acc)


def _plain_fwd(wv, packed, y0_cols, times, n_states, method):
    """Plain version of csrc/blackbox_fwd.cu: the 12 leaves, [NC, R]
    constants, [S, R] y0, [T] times -> [T, S, R] trajectory, stepped by the
    mechanistic kinds' ``fused_ode._one_step``."""
    return fused_ode._integrate(_rhs, (wv, packed, n_states), y0_cols, times, method)


def _plain_fwd_flat(wflat, shapes, packed, y0_cols, times, n_states, method):
    """``_plain_fwd`` on packed weights [n_w], or [F, n_w] with the fold
    axis: each fold's columns on its own weights, as F calls would."""
    n_folds = fused_ode.fold_count(wflat, 1)
    if n_folds is None:
        return _plain_fwd(_split(wflat, shapes), packed, y0_cols, times, n_states, method)
    return torch.cat([
        _plain_fwd(_split(wflat[f], shapes), fused_ode.fold_cols(packed, f, n_folds),
                   fused_ode.fold_cols(y0_cols, f, n_folds), times, n_states, method)
        for f in range(n_folds)], dim=-1)


def _plain_bwd_flat(wflat, shapes, packed, times, traj, g, n_states, method):
    """``_plain_bwd`` on packed weights [n_w] (or [F, n_w]): (dW packed as
    the weights, dc, dy0)."""
    n_folds = fused_ode.fold_count(wflat, 1)
    if n_folds is None:
        dwv, dc, dy0 = _plain_bwd(_split(wflat, shapes), packed, times, traj, g, n_states, method)
        return torch.cat([d.reshape(-1) for d in dwv]), dc, dy0
    parts = [_plain_bwd_flat(wflat[f], shapes, fused_ode.fold_cols(packed, f, n_folds), times,
                             fused_ode.fold_cols(traj, f, n_folds),
                             fused_ode.fold_cols(g, f, n_folds), n_states, method)
             for f in range(n_folds)]
    return (torch.stack([p[0] for p in parts]), torch.cat([p[1] for p in parts], dim=-1),
            torch.cat([p[2] for p in parts], dim=-1))


def _plain_bwd(wv, packed, times, traj, g, n_states, method, relu_mask=_relu_live):
    """Plain version of csrc/blackbox_bwd.cu: the reverse sweep over the
    stored trajectory ``traj`` [T, S, R] for its cotangent ``g`` (the
    mechanistic kinds' ``fused_ode._sweep``).  Returns (the 12 leaves'
    cotangents summed over the rows, dc [NC, R], dy0 [S, R]).

    ``relu_mask(h)`` is called on each hidden layer's activations [H, R], in
    the order the sweep pulls back through them, and returns the mask of the
    units that pass a cotangent (``h > 0`` unless given): a check can run a
    float64 sweep on the masks a float32 sweep took, so that both take the
    same side of each relu's kink."""
    acc = {"c": torch.zeros_like(packed), "w": [torch.zeros_like(w) for w in wv],
           "relu_mask": relu_mask}
    dy0 = fused_ode._sweep(_rhs, _vjp, (wv, packed, n_states), acc, times, traj, g, method)
    return tuple(acc["w"]), acc["c"], dy0


def _split(wflat, shapes):
    """The packed [n_w] weights -> the 12 leaves (views)."""
    out, i = [], 0
    for s in shapes:
        n = torch.Size(s).numel()
        out.append(wflat[i:i + n].view(s))
        i += n
    return out


# --------------------------------------------------------------------------- #
# CUDA kernels
# --------------------------------------------------------------------------- #
def _check_widths(kernel, shapes, n_states, n_const):
    if (tuple(shapes) != KERNEL_LEAF_SHAPES or n_states != KERNEL_N_STATES
            or n_const != KERNEL_N_CONST):
        raise ValueError(
            "%s is built for %d states, %d constants and weight leaves %s; got %d, %d, %s "
            "(blackbox_simulate's callers check supported() first)"
            % (kernel, KERNEL_N_STATES, KERNEL_N_CONST, KERNEL_LEAF_SHAPES, n_states, n_const,
               tuple(shapes)))


def _weight_shape(kernel, wflat, R):
    """(the weight operand's shape, [1760] or [F, 1760]; F or None)."""
    n_folds = fused_ode.fold_count(wflat, 1)
    if n_folds is None:
        return (KERNEL_N_W,), None
    if n_folds < 1 or R % n_folds:
        raise ValueError("%s: %d rows do not split into %d folds" % (kernel, R, n_folds))
    return (n_folds, KERNEL_N_W), n_folds


def blackbox_fwd(wflat, packed, y0_cols, times, shapes, n_states, method):
    """Launch csrc/blackbox_fwd.cu on the current stream: the packed [1760]
    weights, [21, R] constants, [10, R] y0, [T] times -> [T, 10, R].  With
    weights [F, 1760] the rows are F folds', fold-major, each run on its own
    weights in the one launch.  CUDA tensors only; ``_plain_fwd`` is its
    plain version."""
    R, T, S = packed.shape[1], times.shape[0], n_states + N_PREC
    _check_widths("blackbox_fwd", shapes, n_states, packed.shape[0])
    w_shape, n_folds = _weight_shape("blackbox_fwd", wflat, R)
    operands = [("weights", wflat, w_shape), ("constants", packed, (KERNEL_N_CONST, R)),
                ("y0", y0_cols, (S, R)), ("times", times, (T,))]
    fused_ode._check_operands("blackbox_fwd", packed.device, operands)
    out = torch.empty((T, S, R), dtype=torch.float32, device=packed.device)
    fused_ode._launch("blackbox_fwd", R, T, method, packed.device, *[t for _, t, _ in operands],
                      out, folds=n_folds)
    COUNTERS["blackbox_fwd"].launches += 1
    return out


def blackbox_bwd(wflat, packed, times, traj, g, shapes, n_states, method):
    """Launch csrc/blackbox_bwd.cu on the current stream: the reverse sweep
    for the trajectory cotangent ``g``.  Returns (dW [1760], packed as
    ``wflat``; dc [21, R]; dy0 [10, R]).  The kernel writes one partial sum
    of dW per block of ``BWD_ROWS`` sample rows, each reduced in a fixed order;
    their sum here is the last step, so two runs give the same dW bit for
    bit.  With weights [F, 1760] dW is [F, 1760], each fold's partials summed
    as a launch on that fold alone sums them.  CUDA tensors only;
    ``_plain_bwd`` is its plain version."""
    R, T, S = packed.shape[1], times.shape[0], n_states + N_PREC
    _check_widths("blackbox_bwd", shapes, n_states, packed.shape[0])
    w_shape, n_folds = _weight_shape("blackbox_bwd", wflat, R)
    operands = [("weights", wflat, w_shape), ("constants", packed, (KERNEL_N_CONST, R)),
                ("times", times, (T,)), ("trajectory", traj, (T, S, R)),
                ("cotangent", g, (T, S, R))]
    fused_ode._check_operands("blackbox_bwd", packed.device, operands)
    n_blocks = -(-(R // (n_folds or 1)) // BWD_ROWS)
    partials = torch.empty((n_folds or 1, n_blocks, KERNEL_N_W), dtype=torch.float32,
                           device=packed.device)
    dc = torch.empty_like(packed)
    dy0 = torch.empty((S, R), dtype=torch.float32, device=packed.device)
    fused_ode._launch("blackbox_bwd", R, T, method, packed.device, *[t for _, t, _ in operands],
                      partials, dc, dy0, folds=n_folds)
    COUNTERS["blackbox_bwd"].launches += 1
    return fused_ode.fold_partial_sums(partials, n_folds), dc, dy0


def _block(kernel, method):
    fn = getattr(build.load(kernel), kernel + "_block")
    out = [ctypes.c_int() for _ in range(3)]
    err = fn(ctypes.c_int(fused_ode.METHODS.index(method)), *[ctypes.byref(x) for x in out])
    if err != 0:
        raise RuntimeError("%s block query failed with cudaError %d" % (kernel, err))
    return tuple(x.value for x in out)


def fwd_block(method):
    """The forward kernel's block for ``method`` on the current card:
    (threads, shared memory in bytes, blocks one SM holds at once), from
    csrc/blackbox_fwd.cu and the CUDA occupancy calculator."""
    return _block("blackbox_fwd", method)


def bwd_block(method):
    """The backward kernel's block for ``method`` on the current card:
    (threads, dynamic shared memory in bytes, blocks one SM holds at once),
    from csrc/blackbox_bwd.cu and the CUDA occupancy calculator."""
    return _block("blackbox_bwd", method)


class _BlackboxIntegrate(torch.autograd.Function):
    """(packed weights [n_w] or [F, n_w], [NC, R] constants, [S, R] y0, [T]
    times, one fold's leaf shapes, n_states, method) -> [T, S, R] trajectory,
    differentiable in the
    weights, the constants and y0 (the TPU kernel's ``_integrate_padded``
    custom VJP; times get no cotangent).  CUDA tensors launch
    csrc/blackbox_fwd.cu and csrc/blackbox_bwd.cu; CPU tensors run the plain
    versions."""

    @staticmethod
    def forward(ctx, wflat, packed, y0_cols, times, shapes, n_states, method):
        if packed.device.type == "cuda":
            traj = blackbox_fwd(wflat, packed, y0_cols, times, shapes, n_states, method)
        else:
            traj = _plain_fwd_flat(wflat, shapes, packed, y0_cols, times, n_states, method)
        ctx.shapes, ctx.n_states, ctx.method = shapes, n_states, method
        ctx.save_for_backward(wflat, packed, times, traj)
        return traj

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_traj):
        wflat, packed, times, traj = ctx.saved_tensors
        g = grad_traj.contiguous()
        if packed.device.type == "cuda":
            dw, dc, dy0 = blackbox_bwd(wflat, packed, times, traj, g, ctx.shapes, ctx.n_states,
                                       ctx.method)
        else:
            dw, dc, dy0 = _plain_bwd_flat(wflat, ctx.shapes, packed, times, traj, g,
                                          ctx.n_states, ctx.method)
        return dw, dc, dy0, None, None, None, None


# --------------------------------------------------------------------------- #
# Public wrappers
# --------------------------------------------------------------------------- #
def _pack(params, constants, y0):
    """(the 12 leaves, packed [n_w] weights, [NC, R] constants, [S, R] y0)
    from the DR_Blackbox params, constants [B, K, NC] and y0 [B, K, S].
    Leaves with a fold axis pack into [F, n_w]."""
    B, K, S = y0.shape
    R = B * K
    wv = [params[a][b][c] for a, b, c in WEIGHT_LEAVES]
    n_folds = _leaf_folds(wv)
    if n_folds is None:
        wflat = torch.cat([w.reshape(-1) for w in wv])
    else:
        wflat = torch.cat([w.reshape(n_folds, -1) for w in wv], dim=1)
    packed = torch.broadcast_to(constants, (B, K, constants.shape[-1])).reshape(R, -1)
    return wv, wflat, packed.t().contiguous(), y0.reshape(R, S).t().contiguous()


def _leaf_folds(wv):
    """F of the 12 leaves with a fold axis (the hidden bias [F, n]), or None."""
    return fused_ode.fold_count(wv[1], 1)


def _leaf_shapes(wv):
    """One fold's shapes of the 12 leaves."""
    skip = 0 if _leaf_folds(wv) is None else 1
    return tuple(tuple(w.shape[skip:]) for w in wv)


def _check(y0, n_states):
    if y0.shape[-1] != n_states + N_PREC:
        raise ValueError("fused black-box ODE: y0 has %d states, want %d + %d"
                         % (y0.shape[-1], n_states, N_PREC))


def blackbox_simulate(params, constants, y0, times, n_states, method="midpoint"):
    """Fused black-box integration, differentiable in the nets' params, the
    constants and y0.

    ``params``: the DR_Blackbox param dict (its 'states' and 'precisions'
    nets, each with 'hidden' / 'prod' / 'degr' linear leaves);
    ``constants``: [B, K, NC] per-sample constant features; ``y0``:
    [B, K, n_states + 4]; ``times``: [T].  Returns [T, B, K, n_states + 4].
    CPU tensors take the plain PyTorch versions; CUDA tensors launch
    csrc/blackbox_fwd.cu, and csrc/blackbox_bwd.cu when the gradient is
    taken, or raise."""
    fused_ode._check_method(method)
    _check(y0, n_states)
    if y0.device.type not in ("cpu", "cuda"):
        raise ValueError("blackbox_simulate: no kernel for device %s" % y0.device)
    B, K, _ = y0.shape
    wv, wflat, packed, y0_cols = _pack(params, constants, y0)
    shapes = _leaf_shapes(wv)
    out = _BlackboxIntegrate.apply(wflat, packed, y0_cols, times.contiguous(), shapes, n_states,
                                   method)
    return fused_ode._unpack(out, B, K)


def blackbox_simulate_plain(params, constants, y0, times, n_states, method="midpoint"):
    """Plain PyTorch version of ``blackbox_simulate`` on any device."""
    fused_ode._check_method(method)
    _check(y0, n_states)
    B, K, _ = y0.shape
    wv, wflat, packed, y0_cols = _pack(params, constants, y0)
    return fused_ode._unpack(
        _plain_fwd_flat(wflat, _leaf_shapes(wv), packed, y0_cols, times, n_states, method), B, K)


#: kernel -> the function whose ``launches`` attribute counts its launches
#: since the count was last set to 0 (as ``fused_ode.COUNTERS``)
COUNTERS = {"blackbox_fwd": blackbox_simulate, "blackbox_bwd": blackbox_bwd}
for _fn in COUNTERS.values():
    _fn.launches = 0
del _fn
