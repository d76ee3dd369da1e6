"""Fused ODE integration for the mechanistic families: the port's counterpart
of ``vihds_tpu/ops/pallas_ode.py``.

Ported so far: kind ``"dr"`` forward (dr_constant v1/v2, 8 states), as the
hand-written CUDA kernel ``vihds_tpu_torch/csrc/dr_fwd.cu`` (one thread per
sample row, the whole time loop in registers; see the note in the source).
``dr_constant_simulate`` is its wrapper; ``dr_constant_simulate_plain`` is
the same function in plain PyTorch.  On a CPU tensor the wrapper runs the
plain version; on a CUDA tensor it launches the kernel or raises.

The serving forward needs no gradient, so the kernel is forward-only: it
refuses CUDA tensors that require grad.  Its backward kernel (the TPU
kernel's ``_make_bwd_kernel``) comes with the training slice, as do the
``relay`` / ``degrader`` / ``*_prec`` kinds (ROADMAP queue 2).
"""

import ctypes

import torch

from vihds_tpu_torch.ops import build

# Packed constant order for the dr_constant RHS (versions 1 and 2: the version
# difference lives entirely in fracLuxR/fracLasR, computed before the kernel).
# csrc/dr_fwd.cu's DrConst enum follows this order.
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
#: fixed-grid methods of the kernel; the index is csrc/dr_fwd.cu's Method enum
METHODS = ("modeuler", "midpoint", "rk4")


# --------------------------------------------------------------------------- #
# Plain PyTorch version
# --------------------------------------------------------------------------- #
def _dr_rhs_cols(c, t, y):
    """dr_constant RHS on [8, R] state columns; ``c`` maps constant names to
    [R] rows.  Same math and order as the kernel's ``dr_rhs``."""
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


def _one_step(c, t1, t2, y, method):
    """One fixed-grid update on [8, R] columns."""
    h = t2 - t1
    if method == "modeuler":
        f1 = _dr_rhs_cols(c, t1, y)
        f2 = _dr_rhs_cols(c, t2, y + h * f1)
        return y + 0.5 * h * (f1 + f2)
    if method == "midpoint":
        f1 = _dr_rhs_cols(c, t1, y)
        f2 = _dr_rhs_cols(c, t1 + 0.5 * h, y + 0.5 * h * f1)
        return y + h * f2
    if method == "rk4":
        k1 = _dr_rhs_cols(c, t1, y)
        k2 = _dr_rhs_cols(c, t1 + 0.5 * h, y + 0.5 * h * k1)
        k3 = _dr_rhs_cols(c, t1 + 0.5 * h, y + 0.5 * h * k2)
        k4 = _dr_rhs_cols(c, t2, y + h * k3)
        return y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    raise ValueError(method)


def _integrate_plain(packed, y0_cols, times, method):
    """[23, R] constants, [8, R] y0, [T] times -> [T, 8, R] trajectory."""
    c = dict(zip(DR_CONST_NAMES, packed))
    ys = [y0_cols]
    y = y0_cols
    for i in range(times.shape[0] - 1):
        y = _one_step(c, times[i], times[i + 1], y, method)
        ys.append(y)
    return torch.stack(ys, dim=0)


# --------------------------------------------------------------------------- #
# CUDA kernel
# --------------------------------------------------------------------------- #
def _launcher():
    fn = build.load("dr_fwd").dr_fwd_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _integrate_cuda(packed, y0_cols, times, method):
    """Launch csrc/dr_fwd.cu on the current stream; returns [T, 8, R]."""
    NC, R = packed.shape
    T = times.shape[0]
    for name, t, shape in (
        ("constants", packed, (len(DR_CONST_NAMES), R)),
        ("y0", y0_cols, (N_SPECIES, R)),
        ("times", times, (T,)),
    ):
        if t.device.type != "cuda" or t.device != packed.device:
            raise ValueError("dr_fwd: %s must be on %s, got %s" % (name, packed.device, t.device))
        if t.dtype != torch.float32:
            raise TypeError("dr_fwd: %s must be float32, got %s" % (name, t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError("dr_fwd: %s has shape %s, want %s" % (name, tuple(t.shape), shape))
        if not t.is_contiguous():
            raise ValueError("dr_fwd: %s must be contiguous" % name)
        if t.requires_grad:
            raise RuntimeError(
                "dr_fwd is forward-only: its backward kernel comes with the training "
                "slice (ROADMAP queue 2, item 2); run the serving path under no_grad"
            )
    if R == 0 or T == 0:
        raise ValueError("dr_fwd: empty input (R=%d, T=%d)" % (R, T))
    out = torch.empty((T, N_SPECIES, R), dtype=torch.float32, device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = _launcher()(
        packed.data_ptr(), y0_cols.data_ptr(), times.data_ptr(), out.data_ptr(),
        R, T, METHODS.index(method), stream,
    )
    if err != 0:
        raise RuntimeError("dr_fwd kernel launch failed with cudaError %d" % err)
    dr_constant_simulate.launches += 1
    return out


# --------------------------------------------------------------------------- #
# Public wrappers
# --------------------------------------------------------------------------- #
def _pack(constants, y0):
    """[B,K]-broadcastable constants -> [23, R]; y0[B,K,8] -> [8, R]."""
    B, K, S = y0.shape
    if S != N_SPECIES:
        raise ValueError("dr_constant_simulate: y0 has %d states, want %d" % (S, N_SPECIES))
    R = B * K
    packed = torch.stack(
        [torch.broadcast_to(constants[name], (B, K)).reshape(R) for name in DR_CONST_NAMES]
    )
    return packed, y0.reshape(R, S).t().contiguous()


def _unpack(out, B, K):
    """[T, 8, R] -> [T, B, K, 8] (a view, no copy)."""
    return out.view(out.shape[0], N_SPECIES, B, K).permute(0, 2, 3, 1)


def _check_method(method):
    if method not in METHODS:
        raise ValueError("dr_constant_simulate: method %r not in %s" % (method, METHODS))


def dr_constant_simulate_plain(constants, y0, times, method="midpoint"):
    """Plain PyTorch version of ``dr_constant_simulate`` on any device."""
    _check_method(method)
    B, K, _ = y0.shape
    packed, y0_cols = _pack(constants, y0)
    return _unpack(_integrate_plain(packed, y0_cols, times, method), B, K)


def dr_constant_simulate(constants, y0, times, method="midpoint"):
    """Fused fixed-grid integration of dr_constant.

    ``constants``: dict name -> [B, K]-broadcastable float32 tensors (the 23
    ``DR_CONST_NAMES``); ``y0``: [B, K, 8]; ``times``: [T].  Returns the
    trajectory [T, B, K, 8] (the JAX package's layout).  CPU tensors take the
    plain PyTorch version; CUDA tensors launch csrc/dr_fwd.cu."""
    _check_method(method)
    B, K, _ = y0.shape
    packed, y0_cols = _pack(constants, y0)
    if y0.device.type == "cpu":
        out = _integrate_plain(packed, y0_cols, times, method)
    elif y0.device.type == "cuda":
        out = _integrate_cuda(packed, y0_cols, times.contiguous(), method)
    else:
        raise ValueError("dr_constant_simulate: no kernel for device %s" % y0.device)
    return _unpack(out, B, K)


#: launches of csrc/dr_fwd.cu since the count was last set to 0
dr_constant_simulate.launches = 0


def simulate_kind(kind, constants, y0, times, method="midpoint"):
    """Family dispatcher used by OdeModel's fused route."""
    if kind != "dr":
        raise NotImplementedError(
            "fused kernel kind %r is not ported yet (ROADMAP queue 2)" % kind
        )
    return dr_constant_simulate(constants, y0, times, method=method)
