"""Fused ODE integration for the mechanistic families: the port's counterpart
of ``vihds_tpu/ops/pallas_ode.py``.

Ported so far, forward and backward, as hand-written CUDA kernels:

* kind ``"dr"`` (dr_constant v1/v2, 8 states): ``csrc/dr_fwd.cu`` (the TPU
  kernel's ``_make_kernel``) integrates and stores the trajectory, and
  ``csrc/dr_bwd.cu`` (``_make_bwd_kernel``) sweeps the stored trajectory
  backwards with a hand-derived per-step VJP;
* kind ``"dr_prec"`` (dr_constant_precisions v1/v2, 12 states: the 8 species
  and 4 learned precisions, ``_with_precisions`` on the TPU):
  ``csrc/dr_prec_fwd.cu`` and ``csrc/dr_prec_bwd.cu``, which also return the
  cotangent of the precision nets' weight matrix, summed over all rows.

All four run one thread per sample row with the whole time loop in
registers, and share the right-hand sides in ``csrc/dr_common.cuh``.

``dr_constant_simulate`` and ``dr_constant_precisions_simulate`` are the
differentiable wrappers: ``_DrIntegrate`` / ``_DrPrecIntegrate``,
``torch.autograd.Function``s at the packed ``[23, R]`` / ``[S, R]`` /
``[T, S, R]`` level, launch the forward kernel in their forward and the
backward kernel in their backward; the packing around them is ordinary
differentiable torch.  On a CPU tensor a Function runs the plain versions
beside the kernels (``_integrate_plain``, ``_integrate_plain_bwd`` and their
``_prec_`` twins); on a CUDA tensor it launches the kernels or raises.  The
``relay`` / ``degrader`` kinds and their ``_prec`` forms are not ported yet
(ROADMAP queue 2).
"""

import ctypes

import torch

from vihds_tpu_torch.ops import build

# Packed constant order for the dr_constant RHS (versions 1 and 2: the version
# difference lives entirely in fracLuxR/fracLasR, computed before the kernel).
# csrc/dr_common.cuh's DrConst enum follows this order.
DR_CONST_NAMES = (
    "r",
    "K",
    "tlag",
    "rc",
    "a530",
    "a480",
    "drfp",
    "dyfp",
    "dcfp",
    "dR",
    "dS",
    "e76",
    "e81",
    "aCFP",
    "aYFP",
    "KGR_76",
    "KGS_76",
    "KGR_81",
    "KGS_81",
    "aR",
    "aS",
    "fracLuxR",
    "fracLasR",
)
N_SPECIES = 8
#: learned-precision states of the *_precisions models
N_PREC = 4
#: the precision nets' weight matrix: rows 0..3 production, 4..7 degradation;
#: column 0 the bias, columns 1.. the weights of tanh([t, species 0..7])
WMAT_SHAPE = (2 * N_PREC, 2 + N_SPECIES)
#: fixed-grid methods of the kernels; the index is csrc/dr_common.cuh's Method enum
METHODS = ("modeuler", "midpoint", "rk4")
#: threads per block of csrc/dr_prec_bwd.cu: its weight cotangent comes back
#: as one [8, 10] partial sum per block
PREC_BWD_THREADS = 32


# --------------------------------------------------------------------------- #
# Plain PyTorch version
# --------------------------------------------------------------------------- #
def _dr_rhs_cols(c, t, y):
    """dr_constant RHS on [8, R] state columns; ``c`` maps constant names to
    [R] rows.  Same math and order as the kernels' ``dr_rhs``."""
    x, rfp, yfp, cfp, f530, f480, luxR, lasR = y
    gr = c["r"] * torch.sigmoid(4.0 * (t - c["tlag"]))
    gamma = gr * (1.0 - x / c["K"])
    boundLuxR = luxR * luxR * c["fracLuxR"]
    boundLasR = lasR * lasR * c["fracLasR"]
    denom76 = 1.0 + c["KGR_76"] * boundLuxR + c["KGS_76"] * boundLasR
    denom81 = 1.0 + c["KGR_81"] * boundLuxR + c["KGS_81"] * boundLasR
    P76 = (c["e76"] + c["KGR_76"] * boundLuxR + c["KGS_76"] * boundLasR) / denom76
    P81 = (c["e81"] + c["KGR_81"] * boundLuxR + c["KGS_81"] * boundLasR) / denom81
    return torch.stack(
        [
            gamma * x,
            c["rc"] - (gamma + c["drfp"]) * rfp,
            c["rc"] * c["aYFP"] * P81 - (gamma + c["dyfp"]) * yfp,
            c["rc"] * c["aCFP"] * P76 - (gamma + c["dcfp"]) * cfp,
            c["rc"] * c["a530"] - gamma * f530,
            c["rc"] * c["a480"] - gamma * f480,
            c["rc"] * c["aR"] - (gamma + c["dR"]) * luxR,
            c["rc"] * c["aS"] - (gamma + c["dS"]) * lasR,
        ],
        dim=0,
    )


def _prec_features(t, y):
    """The precision nets' input on [S, R] columns: [1; tanh(t); tanh(y_0..7)]
    [10, R] (the activation covers the whole input [t, species], as
    ``NeuralPrecisions.rhs`` applies it)."""
    t_row = torch.broadcast_to(torch.as_tensor(t, dtype=y.dtype, device=y.device), y[:1].shape)
    return torch.cat([torch.ones_like(y[:1]), torch.tanh(torch.cat([t_row, y[:N_SPECIES]]))])


def _dr_prec_rhs_cols(c, t, y):
    """dr_constant_precisions RHS on [12, R] columns, ``c = (constants,
    wmat)``: the 8 species of ``_dr_rhs_cols`` and the n_hidden=0
    NeuralPrecisions block (the TPU kernel's ``_with_precisions``)
        dprec_j = sigmoid(Wp_j . f) - sigmoid(Wd_j . f) * prec_j,
    with f = ``_prec_features(t, y)`` and [Wp; Wd] = ``wmat`` [8, 10]."""
    cdict, wmat = c
    gates = torch.sigmoid(wmat @ _prec_features(t, y))  # [8, R]
    dV = gates[:N_PREC] - gates[N_PREC:] * y[N_SPECIES:]
    return torch.cat([_dr_rhs_cols(cdict, t, y[:N_SPECIES]), dV])


def _one_step(rhs, c, t1, t2, y, method):
    """One fixed-grid update of the [S, R] columns ``y`` under ``rhs``."""
    h = t2 - t1
    if method == "modeuler":
        f1 = rhs(c, t1, y)
        f2 = rhs(c, t2, y + h * f1)
        return y + 0.5 * h * (f1 + f2)
    if method == "midpoint":
        f1 = rhs(c, t1, y)
        f2 = rhs(c, t1 + 0.5 * h, y + 0.5 * h * f1)
        return y + h * f2
    if method == "rk4":
        k1 = rhs(c, t1, y)
        k2 = rhs(c, t1 + 0.5 * h, y + 0.5 * h * k1)
        k3 = rhs(c, t1 + 0.5 * h, y + 0.5 * h * k2)
        k4 = rhs(c, t2, y + h * k3)
        return y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    raise ValueError(method)


def _integrate(rhs, c, y0_cols, times, method):
    ys = [y0_cols]
    y = y0_cols
    for i in range(times.shape[0] - 1):
        y = _one_step(rhs, c, times[i], times[i + 1], y, method)
        ys.append(y)
    return torch.stack(ys, dim=0)


def _integrate_plain(packed, y0_cols, times, method):
    """[23, R] constants, [8, R] y0, [T] times -> [T, 8, R] trajectory."""
    return _integrate(_dr_rhs_cols, dict(zip(DR_CONST_NAMES, packed)), y0_cols, times, method)


def _integrate_prec_plain(wmat, packed, y0_cols, times, method):
    """[8, 10] weights, [23, R] constants, [12, R] y0, [T] times -> [T, 12, R]
    trajectory: the plain version of csrc/dr_prec_fwd.cu."""
    c = (dict(zip(DR_CONST_NAMES, packed)), wmat)
    return _integrate(_dr_prec_rhs_cols, c, y0_cols, times, method)


def _dr_rhs_vjp_cols(c, t, y, w, dc):
    """Pullback of ``_dr_rhs_cols`` at (t, y): for the cotangent ``w`` [8, R]
    of its output, returns (df/dy)^T w [8, R] and adds (df/dc)^T w into the
    per-constant rows of ``dc`` (a dict of [R] tensors, replaced, not written
    in place).  Hand-derived, and line for line the arithmetic of
    csrc/dr_common.cuh's ``dr_rhs_vjp``, so the CPU tests pin the kernels'
    derivative.  The places where a derivative is easy to get wrong:

    * ``gr = r * s`` with ``s = sigmoid(4 (t - tlag))``: dgr/dtlag = -4 r s (1 - s);
    * ``gamma = gr (1 - x/K)``: dgamma/dx = -gr/K, dgamma/dK = gr x / K^2;
    * ``P = (e + A) / (1 + A)`` with ``A = KGR bL + KGS bS`` (P76 and P81):
      dP/dA = (1 - e) / (1 + A)^2 and dP/de = 1 / (1 + A);
    * ``bL = luxR^2 fracLuxR`` (and bS): the gradient reaches fracLuxR and
      fracLasR, and through them theta;
    * time gets no cotangent (the TPU kernel returns zeros for it)."""
    x, rfp, yfp, cfp, f530, f480, luxR, lasR = y
    # forward intermediates, recomputed
    sig = torch.sigmoid(4.0 * (t - c["tlag"]))
    gr = c["r"] * sig
    omx = 1.0 - x / c["K"]
    gamma = gr * omx
    luxR2 = luxR * luxR
    lasR2 = lasR * lasR
    boundLuxR = luxR2 * c["fracLuxR"]
    boundLasR = lasR2 * c["fracLasR"]
    denom76 = 1.0 + c["KGR_76"] * boundLuxR + c["KGS_76"] * boundLasR
    denom81 = 1.0 + c["KGR_81"] * boundLuxR + c["KGS_81"] * boundLasR
    P76 = (c["e76"] + c["KGR_76"] * boundLuxR + c["KGS_76"] * boundLasR) / denom76
    P81 = (c["e81"] + c["KGR_81"] * boundLuxR + c["KGS_81"] * boundLasR) / denom81
    rc = c["rc"]
    # pull w back through the eight outputs
    dgamma = (w[0] * x - w[1] * rfp - w[2] * yfp - w[3] * cfp
              - w[4] * f530 - w[5] * f480 - w[6] * luxR - w[7] * lasR)
    dP81 = w[2] * rc * c["aYFP"]
    dP76 = w[3] * rc * c["aCFP"]
    dc["rc"] = dc["rc"] + (w[1] + w[2] * c["aYFP"] * P81 + w[3] * c["aCFP"] * P76
                           + w[4] * c["a530"] + w[5] * c["a480"] + w[6] * c["aR"]
                           + w[7] * c["aS"])
    dc["aYFP"] = dc["aYFP"] + w[2] * rc * P81
    dc["aCFP"] = dc["aCFP"] + w[3] * rc * P76
    dc["a530"] = dc["a530"] + w[4] * rc
    dc["a480"] = dc["a480"] + w[5] * rc
    dc["aR"] = dc["aR"] + w[6] * rc
    dc["aS"] = dc["aS"] + w[7] * rc
    dc["drfp"] = dc["drfp"] - w[1] * rfp
    dc["dyfp"] = dc["dyfp"] - w[2] * yfp
    dc["dcfp"] = dc["dcfp"] - w[3] * cfp
    dc["dR"] = dc["dR"] - w[6] * luxR
    dc["dS"] = dc["dS"] - w[7] * lasR
    # P = (e + A) / (1 + A)
    dA76 = dP76 * (1.0 - c["e76"]) / (denom76 * denom76)
    dA81 = dP81 * (1.0 - c["e81"]) / (denom81 * denom81)
    dc["e76"] = dc["e76"] + dP76 / denom76
    dc["e81"] = dc["e81"] + dP81 / denom81
    dc["KGR_76"] = dc["KGR_76"] + dA76 * boundLuxR
    dc["KGS_76"] = dc["KGS_76"] + dA76 * boundLasR
    dc["KGR_81"] = dc["KGR_81"] + dA81 * boundLuxR
    dc["KGS_81"] = dc["KGS_81"] + dA81 * boundLasR
    dbL = dA76 * c["KGR_76"] + dA81 * c["KGR_81"]
    dbS = dA76 * c["KGS_76"] + dA81 * c["KGS_81"]
    dc["fracLuxR"] = dc["fracLuxR"] + dbL * luxR2
    dc["fracLasR"] = dc["fracLasR"] + dbS * lasR2
    # gamma = gr (1 - x/K), gr = r sig
    dgr = dgamma * omx
    dc["K"] = dc["K"] + dgamma * gr * x / (c["K"] * c["K"])
    dc["r"] = dc["r"] + dgr * sig
    dc["tlag"] = dc["tlag"] - 4.0 * dgr * c["r"] * sig * (1.0 - sig)
    return torch.stack(
        [
            w[0] * gamma - dgamma * gr / c["K"],
            -w[1] * (gamma + c["drfp"]),
            -w[2] * (gamma + c["dyfp"]),
            -w[3] * (gamma + c["dcfp"]),
            -w[4] * gamma,
            -w[5] * gamma,
            2.0 * dbL * luxR * c["fracLuxR"] - w[6] * (gamma + c["dR"]),
            2.0 * dbS * lasR * c["fracLasR"] - w[7] * (gamma + c["dS"]),
        ],
        dim=0,
    )


def _prec_rhs_vjp_cols(wmat, t, y, w, dc):
    """Pullback of the precision block of ``_dr_prec_rhs_cols`` at (t, y) for
    the cotangent ``w`` [12, R] of the whole right-hand side (only its rows
    8..11, those of dprec, reach the block).  Returns the block's share of
    (df/dy)^T w [12, R] and adds the weights' share into ``dc["W"]``
    [8, 10, R] (per row, summed over the rows at the end of the sweep, as
    csrc/dr_prec_bwd.cu sums each thread's partials).  Hand-derived, line
    for line csrc/dr_common.cuh's ``prec_rhs_vjp``.  With p = Wp f,
    d = Wd f, sp = sigmoid(p), sd = sigmoid(d) and w_j the cotangent of
    dprec_j:

    * dprec_j gets -w_j sd_j;
    * dp_j = w_j sp_j (1 - sp_j), dd_j = -w_j prec_j sd_j (1 - sd_j);
    * dW[j, :] += dp_j f and dW[4 + j, :] += dd_j f;
    * df = Wp^T dp + Wd^T dd, and species s gets df[2 + s] (1 - tanh^2 y_s);
    * f[0] is the constant 1 and f[1] = tanh(t): neither passes anything on."""
    f = _prec_features(t, y)
    sig = torch.sigmoid(wmat @ f)  # [8, R]
    sp, sd = sig[:N_PREC], sig[N_PREC:]
    prec = y[N_SPECIES:]
    wv = w[N_SPECIES:]
    dpd = torch.cat([wv * sp * (1.0 - sp), -wv * prec * sd * (1.0 - sd)])  # [8, R]
    dc["W"] = dc["W"] + dpd[:, None, :] * f[None, :, :]
    df = wmat.t() @ dpd  # [10, R]
    th = f[2:]
    return torch.cat([df[2:] * (1.0 - th * th), -wv * sd])


def _dr_prec_rhs_vjp_cols(c, t, y, w, dc):
    """Pullback of ``_dr_prec_rhs_cols``: the species' pullback
    ``_dr_rhs_vjp_cols`` plus the precision block's ``_prec_rhs_vjp_cols``;
    ``c = (constants, wmat)``, ``dc`` the constants' rows and ``"W"``."""
    cdict, wmat = c
    dy = _prec_rhs_vjp_cols(wmat, t, y, w, dc)
    dx = _dr_rhs_vjp_cols(cdict, t, y[:N_SPECIES], w[:N_SPECIES], dc)
    return torch.cat([dx + dy[:N_SPECIES], dy[N_SPECIES:]])


def _step_vjp(rhs, vjp, c, t1, t2, y, a, dc, method):
    """Pullback of ``_one_step`` at y = y_i: ``a`` is the cotangent of the
    step's output y_{i+1}; returns that of y_i and adds the constants'
    share into ``dc``.  The stages are recomputed from y_i, as the kernels
    (csrc/dr_common.cuh ``step_vjp``) do."""
    h = t2 - t1
    hh = 0.5 * h
    if method == "modeuler":
        # y' = y + hh (f1 + f2), f1 = F(t1, y), f2 = F(t2, y + h f1)
        f1 = rhs(c, t1, y)
        dz = vjp(c, t2, y + h * f1, hh * a, dc)
        d1 = vjp(c, t1, y, hh * a + h * dz, dc)
        return a + dz + d1
    if method == "midpoint":
        # y' = y + h f2, f2 = F(t1 + hh, y + hh f1), f1 = F(t1, y)
        f1 = rhs(c, t1, y)
        dz = vjp(c, t1 + hh, y + hh * f1, h * a, dc)
        d1 = vjp(c, t1, y, hh * dz, dc)
        return a + dz + d1
    if method == "rk4":
        # y' = y + h6 (k1 + 2 k2 + 2 k3 + k4), stage k_j = F(t_j, z_j)
        tm = t1 + hh
        h6 = h / 6.0
        k1 = rhs(c, t1, y)
        z2 = y + hh * k1
        k2 = rhs(c, tm, z2)
        z3 = y + hh * k2
        k3 = rhs(c, tm, z3)
        z4 = y + h * k3
        d4 = vjp(c, t2, z4, h6 * a, dc)
        d3 = vjp(c, tm, z3, 2.0 * h6 * a + h * d4, dc)
        d2 = vjp(c, tm, z2, 2.0 * h6 * a + hh * d3, dc)
        d1 = vjp(c, t1, y, h6 * a + hh * d2, dc)
        return a + d4 + d3 + d2 + d1
    raise ValueError(method)


def _sweep(rhs, vjp, c, dc, times, traj, g, method):
    """The reverse sweep over the stored trajectory ``traj`` [T, S, R] for
    the trajectory cotangent ``g``; accumulates into ``dc`` and returns the
    cotangent of y0 [S, R]."""
    a = g[-1]
    for i in range(times.shape[0] - 2, -1, -1):
        a = _step_vjp(rhs, vjp, c, times[i], times[i + 1], traj[i], a, dc, method) + g[i]
    return a


def _integrate_plain_bwd(packed, times, traj, g, method):
    """Plain version of csrc/dr_bwd.cu: the reverse sweep over the stored
    trajectory ``traj`` [T, 8, R] for the trajectory cotangent ``g``
    [T, 8, R].  Returns (dc [23, R], dy0 [8, R])."""
    c = dict(zip(DR_CONST_NAMES, packed))
    dc = {name: torch.zeros_like(packed[0]) for name in DR_CONST_NAMES}
    dy0 = _sweep(_dr_rhs_cols, _dr_rhs_vjp_cols, c, dc, times, traj, g, method)
    return torch.stack([dc[name] for name in DR_CONST_NAMES]), dy0


def _integrate_prec_plain_bwd(wmat, packed, times, traj, g, method):
    """Plain version of csrc/dr_prec_bwd.cu: the reverse sweep over
    ``traj`` [T, 12, R] for ``g`` [T, 12, R].  Returns (dW [8, 10] summed over
    the rows, dc [23, R], dy0 [12, R])."""
    c = (dict(zip(DR_CONST_NAMES, packed)), wmat)
    dc = {name: torch.zeros_like(packed[0]) for name in DR_CONST_NAMES}
    dc["W"] = torch.zeros(WMAT_SHAPE + (packed.shape[1],), dtype=packed.dtype,
                          device=packed.device)
    dy0 = _sweep(_dr_prec_rhs_cols, _dr_prec_rhs_vjp_cols, c, dc, times, traj, g, method)
    return dc["W"].sum(dim=-1), torch.stack([dc[name] for name in DR_CONST_NAMES]), dy0


# --------------------------------------------------------------------------- #
# CUDA kernels
# --------------------------------------------------------------------------- #
def _launcher(name, n_ptr):
    """The ctypes entry point ``<name>_launch`` of csrc/<name>.cu: ``n_ptr``
    device pointers and the stream as ``c_void_p``, then (R, T, method) ints."""
    fn = getattr(build.load(name), name + "_launch")
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * n_ptr + [ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _check_operands(kernel, device, operands):
    """Raise unless every (name, tensor, shape) is a contiguous float32
    tensor of that shape on the CUDA ``device``."""
    for name, t, shape in operands:
        if t.device.type != "cuda":
            raise ValueError("%s: %s must be on a CUDA device, got %s" % (kernel, name, t.device))
        if t.device != device:
            raise ValueError("%s: %s must be on %s, got %s" % (kernel, name, device, t.device))
        if t.dtype != torch.float32:
            raise TypeError("%s: %s must be float32, got %s" % (kernel, name, t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError("%s: %s has shape %s, want %s" % (kernel, name, tuple(t.shape), shape))
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (kernel, name))


def _launch(name, R, T, method, device, *tensors):
    if R == 0 or T == 0:
        raise ValueError("%s: empty input (R=%d, T=%d)" % (name, R, T))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _launcher(name, len(tensors))(*[t.data_ptr() for t in tensors], R, T,
                                        METHODS.index(method), stream)
    if err != 0:
        raise RuntimeError("%s kernel launch failed with cudaError %d" % (name, err))


def _integrate_cuda(packed, y0_cols, times, method):
    """Launch csrc/dr_fwd.cu on the current stream; returns [T, 8, R]."""
    R, T = packed.shape[1], times.shape[0]
    _check_operands("dr_fwd", packed.device, (
        ("constants", packed, (len(DR_CONST_NAMES), R)),
        ("y0", y0_cols, (N_SPECIES, R)),
        ("times", times, (T,)),
    ))
    out = torch.empty((T, N_SPECIES, R), dtype=torch.float32, device=packed.device)
    _launch("dr_fwd", R, T, method, packed.device, packed, y0_cols, times, out)
    dr_constant_simulate.launches += 1
    return out


def dr_bwd(packed, times, traj, g, method):
    """Launch csrc/dr_bwd.cu on the current stream: the reverse sweep for
    the trajectory cotangent ``g``.  Returns (dc [23, R], dy0 [8, R]).
    CUDA tensors only; ``_integrate_plain_bwd`` is its plain version."""
    R, T = packed.shape[1], times.shape[0]
    _check_operands("dr_bwd", packed.device, (
        ("constants", packed, (len(DR_CONST_NAMES), R)),
        ("times", times, (T,)),
        ("trajectory", traj, (T, N_SPECIES, R)),
        ("cotangent", g, (T, N_SPECIES, R)),
    ))
    dc = torch.empty_like(packed)
    dy0 = torch.empty((N_SPECIES, R), dtype=torch.float32, device=packed.device)
    _launch("dr_bwd", R, T, method, packed.device, packed, times, traj, g, dc, dy0)
    dr_bwd.launches += 1
    return dc, dy0


#: launches of csrc/dr_bwd.cu since the count was last set to 0
dr_bwd.launches = 0


def _integrate_prec_cuda(wmat, packed, y0_cols, times, method):
    """Launch csrc/dr_prec_fwd.cu on the current stream; returns [T, 12, R]."""
    R, T, S = packed.shape[1], times.shape[0], N_SPECIES + N_PREC
    _check_operands("dr_prec_fwd", packed.device, (
        ("weights", wmat, WMAT_SHAPE),
        ("constants", packed, (len(DR_CONST_NAMES), R)),
        ("y0", y0_cols, (S, R)),
        ("times", times, (T,)),
    ))
    out = torch.empty((T, S, R), dtype=torch.float32, device=packed.device)
    _launch("dr_prec_fwd", R, T, method, packed.device, wmat, packed, y0_cols, times, out)
    dr_constant_precisions_simulate.launches += 1
    return out


def dr_prec_bwd(wmat, packed, times, traj, g, method):
    """Launch csrc/dr_prec_bwd.cu on the current stream: the reverse sweep
    for the trajectory cotangent ``g``.  Returns (dW [8, 10], dc [23, R],
    dy0 [12, R]).  The kernel writes one [8, 10] partial sum of dW per block
    of ``PREC_BWD_THREADS`` rows; their sum here is the last step of a
    reduction whose order is fixed, so two runs give the same dW bit for
    bit.  CUDA tensors only; ``_integrate_prec_plain_bwd`` is its plain
    version."""
    R, T, S = packed.shape[1], times.shape[0], N_SPECIES + N_PREC
    _check_operands("dr_prec_bwd", packed.device, (
        ("weights", wmat, WMAT_SHAPE),
        ("constants", packed, (len(DR_CONST_NAMES), R)),
        ("times", times, (T,)),
        ("trajectory", traj, (T, S, R)),
        ("cotangent", g, (T, S, R)),
    ))
    n_blocks = -(-R // PREC_BWD_THREADS)
    dw = torch.empty((n_blocks,) + WMAT_SHAPE, dtype=torch.float32, device=packed.device)
    dc = torch.empty_like(packed)
    dy0 = torch.empty((S, R), dtype=torch.float32, device=packed.device)
    _launch("dr_prec_bwd", R, T, method, packed.device, wmat, packed, times, traj, g, dw, dc,
            dy0)
    dr_prec_bwd.launches += 1
    return dw.sum(dim=0), dc, dy0


#: launches of csrc/dr_prec_bwd.cu since the count was last set to 0
dr_prec_bwd.launches = 0


class _DrIntegrate(torch.autograd.Function):
    """[23, R] constants, [8, R] y0, [T] times -> [T, 8, R] trajectory,
    differentiable in the constants and y0 (the TPU kernel's
    ``_integrate_padded`` custom VJP).  CUDA tensors launch dr_fwd / dr_bwd;
    CPU tensors run the plain versions."""

    @staticmethod
    def forward(ctx, packed, y0_cols, times, method):
        if packed.device.type == "cuda":
            traj = _integrate_cuda(packed, y0_cols, times, method)
        else:
            traj = _integrate_plain(packed, y0_cols, times, method)
        ctx.method = method
        ctx.save_for_backward(packed, times, traj)
        return traj

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_traj):
        packed, times, traj = ctx.saved_tensors
        g = grad_traj.contiguous()
        if packed.device.type == "cuda":
            dc, dy0 = dr_bwd(packed, times, traj, g, ctx.method)
        else:
            dc, dy0 = _integrate_plain_bwd(packed, times, traj, g, ctx.method)
        return dc, dy0, None, None


class _DrPrecIntegrate(torch.autograd.Function):
    """[8, 10] weights, [23, R] constants, [12, R] y0, [T] times ->
    [T, 12, R] trajectory, differentiable in the weights, the constants and
    y0 (the TPU kernel's ``_integrate_padded_w`` custom VJP).  CUDA tensors
    launch dr_prec_fwd / dr_prec_bwd; CPU tensors run the plain versions."""

    @staticmethod
    def forward(ctx, wmat, packed, y0_cols, times, method):
        if packed.device.type == "cuda":
            traj = _integrate_prec_cuda(wmat, packed, y0_cols, times, method)
        else:
            traj = _integrate_prec_plain(wmat, packed, y0_cols, times, method)
        ctx.method = method
        ctx.save_for_backward(wmat, packed, times, traj)
        return traj

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_traj):
        wmat, packed, times, traj = ctx.saved_tensors
        g = grad_traj.contiguous()
        if packed.device.type == "cuda":
            dw, dc, dy0 = dr_prec_bwd(wmat, packed, times, traj, g, ctx.method)
        else:
            dw, dc, dy0 = _integrate_prec_plain_bwd(wmat, packed, times, traj, g, ctx.method)
        return dw, dc, dy0, None, None


# --------------------------------------------------------------------------- #
# Public wrappers
# --------------------------------------------------------------------------- #
def _pack(constants, y0, n_states=N_SPECIES):
    """[B,K]-broadcastable constants -> [23, R]; y0[B,K,S] -> [S, R]."""
    B, K, S = y0.shape
    if S != n_states:
        raise ValueError("fused ODE: y0 has %d states, want %d" % (S, n_states))
    R = B * K
    packed = torch.stack(
        [torch.broadcast_to(constants[name], (B, K)).reshape(R) for name in DR_CONST_NAMES]
    )
    return packed, y0.reshape(R, S).t().contiguous()


def _unpack(out, B, K):
    """[T, S, R] -> [T, B, K, S] (a view, no copy)."""
    return out.view(out.shape[0], out.shape[1], B, K).permute(0, 2, 3, 1)


def _check_method(method):
    if method not in METHODS:
        raise ValueError("fused ODE: method %r not in %s" % (method, METHODS))


def _prec_wmat(prec_params):
    """Stack the NeuralPrecisions(n_hidden=0) weights into the kernels'
    single [8, 10] matrix operand: rows 0..3 ``prod``, 4..7 ``degr``; column
    0 the bias, columns 1.. ``w.T`` over the input [t, species 0..7].
    ``prec_params``: {'prod': {'w': [9, 4], 'b': [4]}, 'degr': {...}}.  Plain
    torch, so autograd carries dW back to the ``w`` and ``b`` leaves."""
    return torch.cat(
        [torch.cat([prec_params[net]["b"][:, None], prec_params[net]["w"].t()], dim=1)
         for net in ("prod", "degr")],
        dim=0,
    ).contiguous()


def dr_constant_simulate_plain(constants, y0, times, method="midpoint"):
    """Plain PyTorch version of ``dr_constant_simulate`` on any device."""
    _check_method(method)
    B, K, _ = y0.shape
    packed, y0_cols = _pack(constants, y0)
    return _unpack(_integrate_plain(packed, y0_cols, times, method), B, K)


def dr_constant_simulate(constants, y0, times, method="midpoint"):
    """Fused fixed-grid integration of dr_constant, differentiable in the
    constants and y0.

    ``constants``: dict name -> [B, K]-broadcastable float32 tensors (the 23
    ``DR_CONST_NAMES``); ``y0``: [B, K, 8]; ``times``: [T].  Returns the
    trajectory [T, B, K, 8] (the JAX package's layout).  CPU tensors take the
    plain PyTorch versions; CUDA tensors launch csrc/dr_fwd.cu, and
    csrc/dr_bwd.cu when the gradient is taken."""
    _check_method(method)
    B, K, _ = y0.shape
    if y0.device.type not in ("cpu", "cuda"):
        raise ValueError("dr_constant_simulate: no kernel for device %s" % y0.device)
    packed, y0_cols = _pack(constants, y0)
    return _unpack(_DrIntegrate.apply(packed, y0_cols, times.contiguous(), method), B, K)


#: launches of csrc/dr_fwd.cu since the count was last set to 0
dr_constant_simulate.launches = 0


def dr_constant_precisions_simulate_plain(constants, prec_params, y0, times, method="midpoint"):
    """Plain PyTorch version of ``dr_constant_precisions_simulate`` on any
    device."""
    _check_method(method)
    B, K, _ = y0.shape
    packed, y0_cols = _pack(constants, y0, N_SPECIES + N_PREC)
    return _unpack(_integrate_prec_plain(_prec_wmat(prec_params), packed, y0_cols, times,
                                         method), B, K)


def dr_constant_precisions_simulate(constants, prec_params, y0, times, method="midpoint"):
    """Fused integration of dr_constant_precisions (8 species + 4 learned
    precisions; NeuralPrecisions with n_hidden=0, tanh, non-inverse, the
    configuration of specs/dr_constant_precisions*.yaml), differentiable in
    the constants, the precision nets' params and y0.

    ``prec_params``: {'prod', 'degr'} -> {'w': [9, 4], 'b': [4]}; ``y0``:
    [B, K, 12]; the rest as ``dr_constant_simulate``.  Returns [T, B, K, 12].
    CPU tensors take the plain versions; CUDA tensors launch
    csrc/dr_prec_fwd.cu, and csrc/dr_prec_bwd.cu when the gradient is taken."""
    _check_method(method)
    B, K, _ = y0.shape
    if y0.device.type not in ("cpu", "cuda"):
        raise ValueError("dr_constant_precisions_simulate: no kernel for device %s" % y0.device)
    packed, y0_cols = _pack(constants, y0, N_SPECIES + N_PREC)
    traj = _DrPrecIntegrate.apply(_prec_wmat(prec_params), packed, y0_cols, times.contiguous(),
                                  method)
    return _unpack(traj, B, K)


#: launches of csrc/dr_prec_fwd.cu since the count was last set to 0
dr_constant_precisions_simulate.launches = 0


def simulate_kind(kind, constants, y0, times, method="midpoint", prec_params=None):
    """Family dispatcher used by OdeModel's fused route; ``prec_params`` are
    the precision nets' params of the ``*_prec`` kinds."""
    if kind == "dr":
        return dr_constant_simulate(constants, y0, times, method=method)
    if kind == "dr_prec":
        return dr_constant_precisions_simulate(constants, prec_params, y0, times, method=method)
    raise NotImplementedError("fused kernel kind %r is not ported yet (ROADMAP queue 2)" % kind)
