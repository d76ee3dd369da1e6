"""The yardstick's arithmetic: the H100's peaks, the operations and bytes of
each hand-written kernel's call, and the algorithm's operations of a whole
training step or evaluation pass.

Operation counts are float32 operations per sample row, an exp, a tanh, a
log or a division counting as one and a sigmoid as four.  The kernels'
counts follow the right-hand sides and pullbacks as the functions need them
(each stage's right-hand side once, one pullback per stage given its
activations), not what a kernel recomputes; bytes count each input read
once and each output written once.
"""

import math

#: NVIDIA H100 SXM data sheet, at its 700 W power limit: float32 outside the
#: tensor cores, and HBM3
FP32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
#: the precision states the black-box model integrates beside its species
N_PREC = 4
#: operations per sample row of the double-receiver right-hand side and of
#: its pullback (31 to recompute the core's terms, 126 to pull back)
DR_RHS_FLOPS, DR_VJP_FLOPS = 59, 157
#: per-row constants the dr kernel reads
DR_N_CONST = 23


def bound_s(n_bytes, n_flops):
    """The least time the chip could take: the larger of the bytes over the
    memory rate and the operations over the float32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S)


def step_flops(rhs, vjp, S):
    """(forward, backward) operations of one midpoint step per sample row
    from a right-hand side's and a pullback's, with S states: forward two
    right-hand sides and 3 + 4 S for the state updates; backward one
    right-hand side, two pullbacks and 2 + 7 S."""
    return 2 * rhs + 3 + 4 * S, rhs + 2 * vjp + 2 + 7 * S


def bb_nets(n_states, n_const, n_hidden, n_hidden_prec):
    """(n_in, hidden, n_out, inputs pulled back) of the black-box model's
    two nets: the states' net over [x, c], the precisions' over [t, x, c]
    (its time input gets no cotangent)."""
    n_in = n_states + n_const
    return ((n_in, n_hidden, n_states, n_in), (n_in + 1, n_hidden_prec, N_PREC, n_in))


def bb_flops(nets):
    """(right-hand side, pullback) operations per sample row of the
    black-box nets.  Per net with n inputs, hidden width H and o outputs: the
    right-hand side 2 n H + 2 H (bias, relu) + 4 H o + 12 o (biases,
    sigmoids, the update); the pullback given the activations 9 o for the
    output layer's cotangents, 4 H o + H for the hidden cotangent and the
    relu, 2 m H for the m inputs that get a cotangent, and the weights'
    share, a multiply-add a weight and an add a bias."""
    rhs = sum(2 * n * h + 2 * h + 4 * h * o + 12 * o for n, h, o, _ in nets)
    pull = sum(9 * o + 4 * h * o + h + 2 * m * h + 2 * (n * h + 2 * h * o) + h + 2 * o
               for n, h, o, m in nets)
    return rhs, pull


def bb_step_flops(nets, S):
    """(forward, backward) operations of one midpoint step per sample row of
    the black-box kernels: the forward as ``step_flops``; the backward each
    stage's right-hand side once and one pullback through each stage, plus
    the state updates."""
    rhs, pull = bb_flops(nets)
    return step_flops(rhs, pull, S)[0], 2 * (rhs + pull) + 2 + 7 * S


def kernel_cost(kernel, shapes):
    """(bytes, operations) of one call of ``kernel`` at a cell's shapes:
    ``shapes`` has R (rows a call), T, and for the black-box kernels S
    (states), n_const, n_w (weights over every fold) and the nets."""
    R, T = shapes["R"], shapes["T"]
    if kernel == "dr_fwd":
        S = 8
        flops = step_flops(DR_RHS_FLOPS, DR_VJP_FLOPS, S)[0] * (T - 1) * R
        return 4 * (DR_N_CONST * R + S * R + T + T * S * R), flops
    S, nc, nw = shapes["S"], shapes["n_const"], shapes["n_w"]
    fwd, bwd = bb_step_flops(shapes["nets"], S)
    if kernel == "blackbox_fwd":
        return 4 * (nw + nc * R + S * R + T + T * S * R), fwd * (T - 1) * R
    if kernel == "blackbox_bwd":
        # weights, constants, grid, trajectory and its cotangent read; the
        # weights', constants' and y0's cotangents written
        return 4 * (2 * nw + 2 * nc * R + T + 2 * T * S * R + S * R), bwd * (T - 1) * R
    raise KeyError(kernel)


def encoder_flops(n_obs, T, n_filters, filter_size, pool_size, n_hidden, heads):
    """Operations of the encoder for one series: the first differences, the
    valid convolution with its bias, the stride-1 average pool, the dense
    layer with its bias and tanh, and the heads (``heads``: (inputs, outputs,
    bias) of each dense head)."""
    n_conv = T - 1 - (filter_size - 1)
    n_pool = n_conv - (pool_size - 1)
    n_flat = n_pool * n_filters
    return (n_obs * (T - 1) + n_filters * n_conv * (2 * n_obs * filter_size + 1)
            + n_filters * n_pool * pool_size + n_hidden * (2 * n_flat + 2)
            + sum(o * (2 * i + (1 if b else 0)) for i, o, b in heads))


def row_flops(n_theta, n_obs, T, ode_fwd_per_step):
    """Forward operations of one sample row (a series' draw): the draw (a
    multiply-add, an exp, the clip's two compares), log q and log p of it
    (10 each a site), the ODE's steps, the observation map (2 a point of a
    signal), the Gaussian log-likelihood (6 a point) and its sum, and the
    IWAE log-sum-exp (4)."""
    return (n_theta * (5 + 20) + ode_fwd_per_step * (T - 1)
            + n_obs * T * (2 + 6 + 1) + 4)


def eval_extra_flops(n_obs, T, n_states):
    """What an evaluation adds per sample row: the normalised weight (2) and
    the importance-weighted mean (2 a point), second moment (5 a point) and
    states (2 a point of each state)."""
    return 2 + n_obs * T * (2 + 5) + n_states * T * 2


def cell_flops(shapes, train):
    """The algorithm's operations of one training step or one evaluation
    pass at a cell's shapes.  A training step is the forward, its backward
    (the ODE's as its kernels' count; the rest twice the forward, the usual
    count of a reverse pass) and Adam (10 a weight)."""
    enc = encoder_flops(*shapes["encoder"])
    ode_fwd, ode_bwd = shapes["ode_step_flops"]
    n_series, rows = shapes["series"], shapes["rows"]
    T, n_obs = shapes["T"], shapes["n_obs"]
    fwd = n_series * enc + rows * row_flops(shapes["n_theta"], n_obs, T, ode_fwd)
    if not train:
        return fwd + rows * eval_extra_flops(n_obs, T, shapes["n_states_out"])
    rest = fwd - rows * ode_fwd * (T - 1)
    return fwd + 2 * rest + rows * ode_bwd * (T - 1) + 10 * shapes["n_weights"]


def percentile(values, q):
    """The q-th percentile (0-100) by linear interpolation between the
    sorted values (numpy's default)."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
