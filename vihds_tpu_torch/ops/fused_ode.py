"""Fused ODE integration for the mechanistic families: the port's counterpart
of ``vihds_tpu/ops/pallas_ode.py``.

Six kinds, each ported forward and backward as a hand-written CUDA kernel
(``csrc/<kind>_fwd.cu`` and ``csrc/<kind>_bwd.cu``, the TPU kernel's
``_make_kernel`` and ``_make_bwd_kernel``):

* ``"dr"`` (dr_constant v1/v2, 8 states) and ``"dr_prec"``
  (dr_constant_precisions v1/v2: the 8 species and 4 learned precisions,
  ``_with_precisions`` on the TPU);
* ``"relay"`` (relay_constant, 12 states) and ``"relay_prec"`` (16);
* ``"degrader"`` (degrader_constant, 11 states) and ``"degrader_prec"`` (15).

They keep the whole time loop of a sample row in registers, a row over
several warps of a 32-row block (the plain kinds' forwards split its species
over three warps in the order they depend on each other), and share their
device code in ``csrc/dr_common.cuh``: the three families share the dr
species' 8-row core, and the ``_prec`` kinds the precision block, whose
backward also returns the cotangent of the precision nets' weight matrix,
summed over all rows.  ``KINDS`` lists the kinds.

The ``_prec`` kinds take a fold axis, the TPU kernels' grid axis under
``jax.vmap``: a weight matrix ``[F, 8, 2 + NS]`` with the rows of F folds,
fold-major (``R = F * Rf``), runs each fold on its own weights in one
launch, and the backward returns ``dW [F, 8, 2 + NS]``, each fold's partials
summed as a launch on that fold alone sums them.  The plain kinds need no
axis: their constants are per row, so the folds' rows simply stack.

``<family>_simulate`` (``dr_constant_simulate``, ...,
``degrader_constant_precisions_simulate``) are the differentiable wrappers:
``_KindIntegrate``, a ``torch.autograd.Function`` at the packed ``[NC, R]`` /
``[S, R]`` / ``[T, S, R]`` level, launches the forward kernel in its forward
and the backward kernel in its backward; the packing around it is ordinary
differentiable torch.  On a CPU tensor the Function runs the plain versions
beside the kernels (``_plain_fwd``, ``_plain_bwd``); on a CUDA tensor it
launches the kernels or raises.
"""

import ctypes
from typing import NamedTuple

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
# relay_constant: dr_constant's constants and the synthases' and secreted
# signals' (csrc/dr_common.cuh's RelayConst enum follows this order)
RELAY_CONST_NAMES = (
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
    "dluxI",
    "dlasI",
    "e76",
    "e81",
    "aCFP",
    "aYFP",
    "KGR_76",
    "KGS_76",
    "KGR_81",
    "KGS_81",
    "KC6",
    "KC12",
    "Klux",
    "Klas",
    "aR",
    "aS",
    "fracLuxR",
    "fracLasR",
)
# degrader_constant: dr_constant's constants and the lactonase's, with the
# arabinose input PBAD and the degradation rates rC6 / rC12 computed per row
# before the kernel, like fracLuxR / fracLasR (DegraderConst enum)
DEGRADER_CONST_NAMES = (
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
    "aI",
    "daiiA",
    "PBAD",
    "rC6",
    "rC12",
    "fracLuxR",
    "fracLasR",
)
#: species of the dr family, and of the core all three families share
N_SPECIES = 8
#: learned-precision states of the *_precisions models
N_PREC = 4
#: the dr_prec weight matrix (each kind's is ``KINDS[kind].wmat_shape``)
WMAT_SHAPE = (2 * N_PREC, 2 + N_SPECIES)
#: fixed-grid methods of the kernels; the index is csrc/dr_common.cuh's Method enum
METHODS = ("modeuler", "midpoint", "rk4")
#: sample rows a block of the _prec backward kernels sweeps (five warps, one
#: per precision state and one for the species): each block returns its rows'
#: weight cotangent as one partial sum
PREC_BWD_ROWS = 32


class Kind(NamedTuple):
    """A fused kernel kind: its packed constant order, its species, whether
    it carries the precision block, and the public wrapper it is reached by."""

    name: str
    names: tuple
    n_species: int
    prec: bool
    simulate: str

    @property
    def n_states(self):
        return self.n_species + (N_PREC if self.prec else 0)

    @property
    def wmat_shape(self):
        """The precision nets' weight matrix: rows 0..3 production, 4..7
        degradation; column 0 the bias, columns 1.. the weights of
        tanh([t, species 0 .. n_species-1])."""
        return (2 * N_PREC, 2 + self.n_species)

    @property
    def fwd(self):
        """The forward kernel's library (``csrc/<fwd>.cu``)."""
        return self.name + "_fwd"

    @property
    def bwd(self):
        return self.name + "_bwd"


KINDS = {
    k.name: k
    for k in (
        Kind("dr", DR_CONST_NAMES, 8, False, "dr_constant_simulate"),
        Kind("dr_prec", DR_CONST_NAMES, 8, True, "dr_constant_precisions_simulate"),
        Kind("relay", RELAY_CONST_NAMES, 12, False, "relay_constant_simulate"),
        Kind("relay_prec", RELAY_CONST_NAMES, 12, True, "relay_constant_precisions_simulate"),
        Kind("degrader", DEGRADER_CONST_NAMES, 11, False, "degrader_constant_simulate"),
        Kind("degrader_prec", DEGRADER_CONST_NAMES, 11, True,
             "degrader_constant_precisions_simulate"),
    )
}


# --------------------------------------------------------------------------- #
# Plain PyTorch version
# --------------------------------------------------------------------------- #
class _Terms(NamedTuple):
    sig: torch.Tensor
    gr: torch.Tensor
    omx: torch.Tensor
    gamma: torch.Tensor
    luxR2: torch.Tensor
    lasR2: torch.Tensor
    boundLuxR: torch.Tensor
    boundLasR: torch.Tensor
    denom76: torch.Tensor
    denom81: torch.Tensor
    P76: torch.Tensor
    P81: torch.Tensor


def _core_terms(c, t, y):
    """The intermediates of the 8-species core at (t, y) on [S, R] columns;
    ``c`` maps constant names to [R] rows.  csrc/dr_common.cuh's
    ``core_terms``."""
    sig = torch.sigmoid(4.0 * (t - c["tlag"]))
    gr = c["r"] * sig
    omx = 1.0 - y[0] / c["K"]
    luxR2 = y[6] * y[6]
    lasR2 = y[7] * y[7]
    boundLuxR = luxR2 * c["fracLuxR"]
    boundLasR = lasR2 * c["fracLasR"]
    denom76 = 1.0 + c["KGR_76"] * boundLuxR + c["KGS_76"] * boundLasR
    denom81 = 1.0 + c["KGR_81"] * boundLuxR + c["KGS_81"] * boundLasR
    P76 = (c["e76"] + c["KGR_76"] * boundLuxR + c["KGS_76"] * boundLasR) / denom76
    P81 = (c["e81"] + c["KGR_81"] * boundLuxR + c["KGS_81"] * boundLasR) / denom81
    return _Terms(sig, gr, omx, gr * omx, luxR2, lasR2, boundLuxR, boundLasR, denom76, denom81,
                  P76, P81)


def _core_rows(c, k, y):
    """The core's eight rows (``core_rhs``): OD, RFP, YFP, CFP, F530, F480,
    LuxR, LasR."""
    rc, gamma = c["rc"], k.gamma
    return [
        gamma * y[0],
        rc - (gamma + c["drfp"]) * y[1],
        rc * c["aYFP"] * k.P81 - (gamma + c["dyfp"]) * y[2],
        rc * c["aCFP"] * k.P76 - (gamma + c["dcfp"]) * y[3],
        rc * c["a530"] - gamma * y[4],
        rc * c["a480"] - gamma * y[5],
        rc * c["aR"] - (gamma + c["dR"]) * y[6],
        rc * c["aS"] - (gamma + c["dS"]) * y[7],
    ]


def _core_rows_vjp(c, k, y, w, dc):
    """First half of the core's pullback (``core_rows_vjp``): for the
    cotangent ``w`` of the core's rows, adds the share of the constants each
    row reads directly into ``dc`` (a dict of [R] tensors, replaced, not
    written in place) and returns the rows' cotangents (dgamma, dP76, dP81).
    A family's extra rows add their shares to these before
    ``_core_terms_vjp`` pulls them back."""
    rc = c["rc"]
    dgamma = (w[0] * y[0] - w[1] * y[1] - w[2] * y[2] - w[3] * y[3]
              - w[4] * y[4] - w[5] * y[5] - w[6] * y[6] - w[7] * y[7])
    dP81 = w[2] * rc * c["aYFP"]
    dP76 = w[3] * rc * c["aCFP"]
    dc["rc"] = dc["rc"] + (w[1] + w[2] * c["aYFP"] * k.P81 + w[3] * c["aCFP"] * k.P76
                           + w[4] * c["a530"] + w[5] * c["a480"] + w[6] * c["aR"]
                           + w[7] * c["aS"])
    dc["aYFP"] = dc["aYFP"] + w[2] * rc * k.P81
    dc["aCFP"] = dc["aCFP"] + w[3] * rc * k.P76
    dc["a530"] = dc["a530"] + w[4] * rc
    dc["a480"] = dc["a480"] + w[5] * rc
    dc["aR"] = dc["aR"] + w[6] * rc
    dc["aS"] = dc["aS"] + w[7] * rc
    dc["drfp"] = dc["drfp"] - w[1] * y[1]
    dc["dyfp"] = dc["dyfp"] - w[2] * y[2]
    dc["dcfp"] = dc["dcfp"] - w[3] * y[3]
    dc["dR"] = dc["dR"] - w[6] * y[6]
    dc["dS"] = dc["dS"] - w[7] * y[7]
    return dgamma, dP76, dP81


def _core_terms_vjp(c, k, y, w, dgamma, dP76, dP81, dc):
    """Second half of the core's pullback (``core_terms_vjp``): pulls
    dgamma, dP76 and dP81 back through the core's terms into ``dc`` and
    returns the states' cotangent through the core, 8 rows.  The places where
    a derivative is easy to get wrong:

    * ``gr = r * s`` with ``s = sigmoid(4 (t - tlag))``: dgr/dtlag = -4 r s (1 - s);
    * ``gamma = gr (1 - x/K)``: dgamma/dx = -gr/K, dgamma/dK = gr x / K^2;
    * ``P = (e + A) / (1 + A)`` with ``A = KGR bL + KGS bS`` (P76 and P81):
      dP/dA = (1 - e) / (1 + A)^2 and dP/de = 1 / (1 + A);
    * ``bL = luxR^2 fracLuxR`` (and bS): the gradient reaches fracLuxR and
      fracLasR, and through them theta;
    * time gets no cotangent (the TPU kernel returns zeros for it)."""
    dA76 = dP76 * (1.0 - c["e76"]) / (k.denom76 * k.denom76)
    dA81 = dP81 * (1.0 - c["e81"]) / (k.denom81 * k.denom81)
    dc["e76"] = dc["e76"] + dP76 / k.denom76
    dc["e81"] = dc["e81"] + dP81 / k.denom81
    dc["KGR_76"] = dc["KGR_76"] + dA76 * k.boundLuxR
    dc["KGS_76"] = dc["KGS_76"] + dA76 * k.boundLasR
    dc["KGR_81"] = dc["KGR_81"] + dA81 * k.boundLuxR
    dc["KGS_81"] = dc["KGS_81"] + dA81 * k.boundLasR
    dbL = dA76 * c["KGR_76"] + dA81 * c["KGR_81"]
    dbS = dA76 * c["KGS_76"] + dA81 * c["KGS_81"]
    dc["fracLuxR"] = dc["fracLuxR"] + dbL * k.luxR2
    dc["fracLasR"] = dc["fracLasR"] + dbS * k.lasR2
    # gamma = gr (1 - x/K), gr = r sig
    dgr = dgamma * k.omx
    dc["K"] = dc["K"] + dgamma * k.gr * y[0] / (c["K"] * c["K"])
    dc["r"] = dc["r"] + dgr * k.sig
    dc["tlag"] = dc["tlag"] - 4.0 * dgr * c["r"] * k.sig * (1.0 - k.sig)
    gamma = k.gamma
    return [
        w[0] * gamma - dgamma * k.gr / c["K"],
        -w[1] * (gamma + c["drfp"]),
        -w[2] * (gamma + c["dyfp"]),
        -w[3] * (gamma + c["dcfp"]),
        -w[4] * gamma,
        -w[5] * gamma,
        2.0 * dbL * y[6] * c["fracLuxR"] - w[6] * (gamma + c["dR"]),
        2.0 * dbS * y[7] * c["fracLasR"] - w[7] * (gamma + c["dS"]),
    ]


def _dr_rhs_cols(c, t, y):
    """dr_constant RHS on [8, R] state columns: the core alone.  Same math
    and order as the kernels' ``dr_rhs``."""
    return torch.stack(_core_rows(c, _core_terms(c, t, y), y))


def _dr_rhs_vjp_cols(c, t, y, w, dc):
    """Pullback of ``_dr_rhs_cols`` at (t, y): for the cotangent ``w`` [8, R]
    of its output, returns (df/dy)^T w [8, R] and adds (df/dc)^T w into the
    per-constant rows of ``dc``.  Hand-derived, and line for line the
    arithmetic of csrc/dr_common.cuh's ``dr_rhs_vjp``, so the CPU tests pin
    the kernels' derivative."""
    k = _core_terms(c, t, y)
    dgamma, dP76, dP81 = _core_rows_vjp(c, k, y, w, dc)
    return torch.stack(_core_terms_vjp(c, k, y, w, dgamma, dP76, dP81, dc))


def _relay_rhs_cols(c, t, y):
    """relay_constant RHS on [12, R] columns (``relay_rhs``): the core, the
    synthases LuxI / LasI driven by P81 / P76, and the secreted C6 / C12,
    which no row reads (fracLuxR / fracLasR stay at the initial
    treatments)."""
    k = _core_terms(c, t, y)
    x, luxI, lasI, rc = y[0], y[8], y[9], c["rc"]
    return torch.stack(_core_rows(c, k, y) + [
        rc * k.P81 - (k.gamma + c["dluxI"]) * luxI,
        rc * k.P76 - (k.gamma + c["dlasI"]) * lasI,
        (c["KC6"] * rc * x * luxI) / (1.0 + luxI / c["Klux"]),
        (c["KC12"] * rc * x * lasI) / (1.0 + lasI / c["Klas"]),
    ])


def _relay_rhs_vjp_cols(c, t, y, w, dc):
    """Pullback of ``_relay_rhs_cols`` (``relay_rhs_vjp``).  The extra rows
    feed the core's gamma, P81 and P76, so their shares join the core rows'
    before the core's terms are pulled back.  With C6' = n6 / D6,
    n6 = KC6 rc x luxI, D6 = 1 + luxI / Klux: dn6 = w10 / D6,
    dD6 = -dn6 n6 / D6, and D6 passes dD6 / Klux to luxI and
    -dD6 luxI / Klux^2 to Klux (C12' likewise)."""
    k = _core_terms(c, t, y)
    dgamma, dP76, dP81 = _core_rows_vjp(c, k, y, w, dc)
    x, luxI, lasI, rc = y[0], y[8], y[9], c["rc"]
    # luxI' = rc P81 - (gamma + dluxI) luxI, lasI' = rc P76 - (gamma + dlasI) lasI
    dgamma = dgamma - (w[8] * luxI + w[9] * lasI)
    dP81 = dP81 + w[8] * rc
    dP76 = dP76 + w[9] * rc
    dc["rc"] = dc["rc"] + (w[8] * k.P81 + w[9] * k.P76)
    dc["dluxI"] = dc["dluxI"] - w[8] * luxI
    dc["dlasI"] = dc["dlasI"] - w[9] * lasI
    # C6' = n6 / D6, C12' = n12 / D12
    D6 = 1.0 + luxI / c["Klux"]
    D12 = 1.0 + lasI / c["Klas"]
    dn6 = w[10] / D6
    dn12 = w[11] / D12
    dD6 = -dn6 * (c["KC6"] * rc * x * luxI) / D6
    dD12 = -dn12 * (c["KC12"] * rc * x * lasI) / D12
    dc["KC6"] = dc["KC6"] + dn6 * rc * x * luxI
    dc["KC12"] = dc["KC12"] + dn12 * rc * x * lasI
    dc["rc"] = dc["rc"] + (dn6 * c["KC6"] * x * luxI + dn12 * c["KC12"] * x * lasI)
    dc["Klux"] = dc["Klux"] - dD6 * luxI / (c["Klux"] * c["Klux"])
    dc["Klas"] = dc["Klas"] - dD12 * lasI / (c["Klas"] * c["Klas"])
    dy = _core_terms_vjp(c, k, y, w, dgamma, dP76, dP81, dc)
    dy[0] = dy[0] + (dn6 * c["KC6"] * rc * luxI + dn12 * c["KC12"] * rc * lasI)
    zero = torch.zeros_like(x)
    return torch.stack(dy + [
        -w[8] * (k.gamma + c["dluxI"]) + dn6 * c["KC6"] * rc * x + dD6 / c["Klux"],
        -w[9] * (k.gamma + c["dlasI"]) + dn12 * c["KC12"] * rc * x + dD12 / c["Klas"],
        zero,
        zero,
    ])


def _degrader_rhs_cols(c, t, y):
    """degrader_constant RHS on [11, R] columns (``degrader_rhs``): the
    core, the lactonase AiiA driven by the arabinose input PBAD, and C6 / C12,
    which no row reads.  aiiA' as the reference writes it: daiiA is not
    multiplied by aiiA."""
    k = _core_terms(c, t, y)
    x, aiiA = y[0], y[8]
    return torch.stack(_core_rows(c, k, y) + [
        c["rc"] * c["aI"] * c["PBAD"] - (c["daiiA"] + k.gamma * aiiA),
        x * c["rC6"] * aiiA,
        x * c["rC12"] * aiiA,
    ])


def _degrader_rhs_vjp_cols(c, t, y, w, dc):
    """Pullback of ``_degrader_rhs_cols`` (``degrader_rhs_vjp``): aiiA' feeds
    gamma; C6' and C12' read x, aiiA and the host-side rC6 / rC12, whose
    cotangents (and PBAD's) reach theta through autograd of the model's
    constants."""
    k = _core_terms(c, t, y)
    dgamma, dP76, dP81 = _core_rows_vjp(c, k, y, w, dc)
    x, aiiA, rc = y[0], y[8], c["rc"]
    dgamma = dgamma - w[8] * aiiA
    dc["rc"] = dc["rc"] + w[8] * c["aI"] * c["PBAD"]
    dc["aI"] = dc["aI"] + w[8] * rc * c["PBAD"]
    dc["PBAD"] = dc["PBAD"] + w[8] * rc * c["aI"]
    dc["daiiA"] = dc["daiiA"] - w[8]
    dc["rC6"] = dc["rC6"] + w[9] * x * aiiA
    dc["rC12"] = dc["rC12"] + w[10] * x * aiiA
    dy = _core_terms_vjp(c, k, y, w, dgamma, dP76, dP81, dc)
    dC = w[9] * c["rC6"] + w[10] * c["rC12"]
    dy[0] = dy[0] + dC * aiiA
    zero = torch.zeros_like(x)
    return torch.stack(dy + [-w[8] * k.gamma + dC * x, zero, zero])


def _prec_features(t, y, n_species):
    """The precision nets' input on [S, R] columns: [1; tanh(t); tanh(y_0 ..
    y_{n_species-1})] (the activation covers the whole input [t, species], as
    ``NeuralPrecisions.rhs`` applies it)."""
    t_row = torch.broadcast_to(torch.as_tensor(t, dtype=y.dtype, device=y.device), y[:1].shape)
    return torch.cat([torch.ones_like(y[:1]), torch.tanh(torch.cat([t_row, y[:n_species]]))])


def _with_prec_rhs(base_rhs, c, t, y):
    """A *_precisions RHS on [NS + 4, R] columns, ``c = (constants, wmat)``:
    the species of ``base_rhs`` and the n_hidden=0 NeuralPrecisions block
    (the TPU kernel's ``_with_precisions``)
        dprec_j = sigmoid(Wp_j . f) - sigmoid(Wd_j . f) * prec_j,
    with f = ``_prec_features(t, y, NS)`` and [Wp; Wd] = ``wmat`` [8, 2 + NS]."""
    cdict, wmat = c
    ns = wmat.shape[1] - 2
    gates = torch.sigmoid(wmat @ _prec_features(t, y, ns))  # [8, R]
    dV = gates[:N_PREC] - gates[N_PREC:] * y[ns:]
    return torch.cat([base_rhs(cdict, t, y[:ns]), dV])


def _prec_rhs_vjp_cols(wmat, t, y, w, dc):
    """Pullback of the precision block of ``_with_prec_rhs`` at (t, y) for
    the cotangent ``w`` [NS + 4, R] of the whole right-hand side (only its
    last 4 rows, those of dprec, reach the block).  Returns the block's share
    of (df/dy)^T w [NS + 4, R] and adds the weights' share into ``dc["W"]``
    [8, 2 + NS, R] (per row, summed over the rows at the end of the sweep, as
    the backward kernel sums each row's partials).  Hand-derived, line for
    line csrc/dr_common.cuh's ``PrecWarp`` pullback (one warp per precision
    state) and the share ``CoreWarp`` adds.  With p = Wp f, d = Wd f,
    sp = sigmoid(p), sd = sigmoid(d) and w_j the cotangent of dprec_j:

    * dprec_j gets -w_j sd_j;
    * dp_j = w_j sp_j (1 - sp_j), dd_j = -w_j prec_j sd_j (1 - sd_j);
    * dW[j, :] += dp_j f and dW[4 + j, :] += dd_j f;
    * df = Wp^T dp + Wd^T dd, and species s gets df[2 + s] (1 - tanh^2 y_s);
    * f[0] is the constant 1 and f[1] = tanh(t): neither passes anything on."""
    ns = wmat.shape[1] - 2
    f = _prec_features(t, y, ns)
    sig = torch.sigmoid(wmat @ f)  # [8, R]
    sp, sd = sig[:N_PREC], sig[N_PREC:]
    prec = y[ns:]
    wv = w[ns:]
    dpd = torch.cat([wv * sp * (1.0 - sp), -wv * prec * sd * (1.0 - sd)])  # [8, R]
    dc["W"] = dc["W"] + dpd[:, None, :] * f[None, :, :]
    df = wmat.t() @ dpd  # [2 + NS, R]
    th = f[2:]
    return torch.cat([df[2:] * (1.0 - th * th), -wv * sd])


def _with_prec_vjp(base_vjp, c, t, y, w, dc):
    """Pullback of ``_with_prec_rhs``: the species' pullback ``base_vjp``
    plus the precision block's ``_prec_rhs_vjp_cols``; ``c = (constants,
    wmat)``, ``dc`` the constants' rows and ``"W"``."""
    cdict, wmat = c
    ns = wmat.shape[1] - 2
    dy = _prec_rhs_vjp_cols(wmat, t, y, w, dc)
    dx = base_vjp(cdict, t, y[:ns], w[:ns], dc)
    return torch.cat([dx + dy[:ns], dy[ns:]])


def _dr_prec_rhs_cols(c, t, y):
    return _with_prec_rhs(_dr_rhs_cols, c, t, y)


def _dr_prec_rhs_vjp_cols(c, t, y, w, dc):
    return _with_prec_vjp(_dr_rhs_vjp_cols, c, t, y, w, dc)


def _relay_prec_rhs_cols(c, t, y):
    return _with_prec_rhs(_relay_rhs_cols, c, t, y)


def _relay_prec_rhs_vjp_cols(c, t, y, w, dc):
    return _with_prec_vjp(_relay_rhs_vjp_cols, c, t, y, w, dc)


def _degrader_prec_rhs_cols(c, t, y):
    return _with_prec_rhs(_degrader_rhs_cols, c, t, y)


def _degrader_prec_rhs_vjp_cols(c, t, y, w, dc):
    return _with_prec_vjp(_degrader_rhs_vjp_cols, c, t, y, w, dc)


def _rhs_and_vjp(kind):
    """``_<kind>_rhs_cols`` and ``_<kind>_rhs_vjp_cols``, looked up when
    called, so that a test may replace one of them."""
    return globals()["_%s_rhs_cols" % kind], globals()["_%s_rhs_vjp_cols" % kind]


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


def fold_count(w, dims):
    """F of a weight operand with the fold axis (``dims + 1`` dimensions,
    ``[F, ...]``), or None for one without it (``dims`` dimensions)."""
    if w is None or w.dim() == dims:
        return None
    if w.dim() != dims + 1:
        raise ValueError("weights of %d dimensions, want %d or %d (a fold axis)"
                         % (w.dim(), dims, dims + 1))
    return w.shape[0]


def fold_cols(x, f, n_folds):
    """Fold ``f``'s columns of ``x`` [..., R] (R = n_folds * Rf, fold-major)."""
    rf = x.shape[-1] // n_folds
    return x[..., f * rf:(f + 1) * rf]


def _plain_fwd(kind, wmat, packed, y0_cols, times, method):
    """Plain version of csrc/<kind>_fwd.cu: [8, 2 + NS] weights (``_prec``
    kinds; else None), [NC, R] constants, [S, R] y0, [T] times -> [T, S, R]
    trajectory.  Weights [F, 8, 2 + NS] run each fold's columns on its own
    matrix, as F calls would."""
    k = KINDS[kind]
    n_folds = fold_count(wmat, 2)
    if n_folds is not None:
        return torch.cat([_plain_fwd(kind, wmat[f], fold_cols(packed, f, n_folds),
                                     fold_cols(y0_cols, f, n_folds), times, method)
                          for f in range(n_folds)], dim=-1)
    cdict = dict(zip(k.names, packed))
    return _integrate(_rhs_and_vjp(kind)[0], (cdict, wmat) if k.prec else cdict, y0_cols, times,
                      method)


def _plain_bwd(kind, wmat, packed, times, traj, g, method):
    """Plain version of csrc/<kind>_bwd.cu: the reverse sweep over the stored
    trajectory ``traj`` [T, S, R] for the trajectory cotangent ``g``
    [T, S, R].  Returns (dW [8, 2 + NS] summed over the rows, or None without
    the precision block; dc [NC, R]; dy0 [S, R]).  Weights [F, 8, 2 + NS]
    sweep each fold's columns on its own matrix and return dW [F, 8, 2 + NS]."""
    k = KINDS[kind]
    n_folds = fold_count(wmat, 2)
    if n_folds is not None:
        parts = [_plain_bwd(kind, wmat[f], fold_cols(packed, f, n_folds), times,
                            fold_cols(traj, f, n_folds), fold_cols(g, f, n_folds), method)
                 for f in range(n_folds)]
        return (torch.stack([p[0] for p in parts]), torch.cat([p[1] for p in parts], dim=-1),
                torch.cat([p[2] for p in parts], dim=-1))
    rhs, vjp = _rhs_and_vjp(kind)
    cdict = dict(zip(k.names, packed))
    dc = {name: torch.zeros_like(packed[0]) for name in k.names}
    if k.prec:
        dc["W"] = torch.zeros(k.wmat_shape + (packed.shape[1],), dtype=packed.dtype,
                              device=packed.device)
    dy0 = _sweep(rhs, vjp, (cdict, wmat) if k.prec else cdict, dc, times, traj, g, method)
    return (dc["W"].sum(dim=-1) if k.prec else None,
            torch.stack([dc[name] for name in k.names]), dy0)


def _integrate_plain(packed, y0_cols, times, method):
    """[23, R] constants, [8, R] y0, [T] times -> [T, 8, R]: plain dr_fwd."""
    return _plain_fwd("dr", None, packed, y0_cols, times, method)


def _integrate_prec_plain(wmat, packed, y0_cols, times, method):
    """[8, 10] weights, [23, R] constants, [12, R] y0, [T] times ->
    [T, 12, R]: plain dr_prec_fwd."""
    return _plain_fwd("dr_prec", wmat, packed, y0_cols, times, method)


def _integrate_plain_bwd(packed, times, traj, g, method):
    """Plain dr_bwd: (dc [23, R], dy0 [8, R])."""
    return _plain_bwd("dr", None, packed, times, traj, g, method)[1:]


def _integrate_prec_plain_bwd(wmat, packed, times, traj, g, method):
    """Plain dr_prec_bwd: (dW [8, 10], dc [23, R], dy0 [12, R])."""
    return _plain_bwd("dr_prec", wmat, packed, times, traj, g, method)


# --------------------------------------------------------------------------- #
# CUDA kernels
# --------------------------------------------------------------------------- #
#: the kernels whose entry point takes the fold count (after the method):
#: the ``_prec`` kinds' and the black-box ODE's (ops/fused_blackbox.py)
FOLD_KERNELS = frozenset([k + "_" + d for k in ("dr_prec", "relay_prec", "degrader_prec",
                                                "blackbox") for d in ("fwd", "bwd")])


def _launcher(name, n_ptr):
    """The ctypes entry point ``<name>_launch`` of csrc/<name>.cu: ``n_ptr``
    device pointers, then (R, T, method) ints, the fold count for a kernel of
    ``FOLD_KERNELS``, and the stream as ``c_void_p``."""
    fn = getattr(build.load(name), name + "_launch")
    if fn.argtypes is None:
        p = ctypes.c_void_p
        n_int = 4 if name in FOLD_KERNELS else 3
        fn.argtypes = [p] * n_ptr + [ctypes.c_int] * n_int + [p]
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


def _launch(name, R, T, method, device, *tensors, folds=None):
    """Launch kernel ``name`` on ``device``'s current stream; ``folds`` (a
    kernel of ``FOLD_KERNELS``: 1 without the fold axis) is its fold count."""
    if R == 0 or T == 0:
        raise ValueError("%s: empty input (R=%d, T=%d)" % (name, R, T))
    stream = torch.cuda.current_stream(device).cuda_stream
    ints = [R, T, METHODS.index(method)] + ([folds or 1] if name in FOLD_KERNELS else [])
    err = _launcher(name, len(tensors))(*[t.data_ptr() for t in tensors], *ints, stream)
    if err != 0:
        raise RuntimeError("%s kernel launch failed with cudaError %d" % (name, err))


def _weights(k, wmat, R):
    """(the weight operand of kind ``k``'s kernels: [(name, tensor, shape)]
    with the precision block, else []; the fold count F of ``wmat``
    [F, 8, 2 + NS], or None)."""
    if not k.prec:
        return [], None
    n_folds = fold_count(wmat, 2)
    if n_folds is None:
        return [("weights", wmat, k.wmat_shape)], None
    if n_folds < 1 or R % n_folds:
        raise ValueError("%s: %d rows do not split into %d folds" % (k.name, R, n_folds))
    return [("weights", wmat, (n_folds,) + k.wmat_shape)], n_folds


def kind_fwd(kind, wmat, packed, y0_cols, times, method):
    """Launch csrc/<kind>_fwd.cu on the current stream; returns [T, S, R].
    ``wmat`` is the weight matrix of a ``_prec`` kind, else None; with a fold
    axis ([F, 8, 2 + NS]) the rows are F folds', fold-major, each run on its
    own matrix in the one launch.  CUDA tensors only; ``_plain_fwd`` is its
    plain version."""
    k = KINDS[kind]
    R, T = packed.shape[1], times.shape[0]
    weights, n_folds = _weights(k, wmat, R)
    operands = weights + [
        ("constants", packed, (len(k.names), R)),
        ("y0", y0_cols, (k.n_states, R)),
        ("times", times, (T,)),
    ]
    _check_operands(k.fwd, packed.device, operands)
    out = torch.empty((T, k.n_states, R), dtype=torch.float32, device=packed.device)
    _launch(k.fwd, R, T, method, packed.device, *[t for _, t, _ in operands], out,
            folds=n_folds)
    COUNTERS[k.fwd].launches += 1
    return out


def kind_bwd(kind, wmat, packed, times, traj, g, method):
    """Launch csrc/<kind>_bwd.cu on the current stream: the reverse sweep
    for the trajectory cotangent ``g``.  Returns (dW [8, 2 + NS] or None,
    dc [NC, R], dy0 [S, R]).  A ``_prec`` kernel writes one partial sum of dW
    per block of ``PREC_BWD_ROWS`` rows; their sum here is the last step
    of a reduction whose order is fixed, so two runs give the same dW bit for
    bit.  With a fold axis (``wmat`` [F, 8, 2 + NS]) dW is [F, 8, 2 + NS],
    each fold's partials summed as a launch on that fold alone sums them.
    CUDA tensors only; ``_plain_bwd`` is its plain version."""
    k = KINDS[kind]
    R, T, S = packed.shape[1], times.shape[0], k.n_states
    weights, n_folds = _weights(k, wmat, R)
    operands = weights + [
        ("constants", packed, (len(k.names), R)),
        ("times", times, (T,)),
        ("trajectory", traj, (T, S, R)),
        ("cotangent", g, (T, S, R)),
    ]
    _check_operands(k.bwd, packed.device, operands)
    outs = []
    if k.prec:
        n_blocks = -(-(R // (n_folds or 1)) // PREC_BWD_ROWS)
        outs.append(torch.empty((n_folds or 1, n_blocks) + k.wmat_shape, dtype=torch.float32,
                                device=packed.device))
    dc = torch.empty_like(packed)
    dy0 = torch.empty((S, R), dtype=torch.float32, device=packed.device)
    _launch(k.bwd, R, T, method, packed.device, *[t for _, t, _ in operands], *outs, dc, dy0,
            folds=n_folds)
    COUNTERS[k.bwd].launches += 1
    return (fold_partial_sums(outs[0], n_folds) if k.prec else None), dc, dy0


def fold_partial_sums(partials, n_folds):
    """A backward's weight cotangent from its per-block partials [F, n_blocks,
    ...]: the sum over blocks, fold by fold, each over the contiguous
    [n_blocks, ...] slice a launch on that fold alone would have written, so
    each fold's dW is that launch's bit for bit.  ``n_folds`` None drops the
    fold axis (a launch without it)."""
    if n_folds is None:
        return partials[0].sum(dim=0)
    return torch.stack([partials[f].sum(dim=0) for f in range(n_folds)])


def _block(name, method):
    """The block of kernel library ``name`` for ``method`` on the current
    card, from its C entry ``<name>_block``: (sample rows, threads, static
    shared memory in bytes, registers a thread, blocks one SM holds at once),
    the last from the CUDA occupancy calculator."""
    fn = getattr(build.load(name), name + "_block")
    out = [ctypes.c_int() for _ in range(5)]
    err = fn(ctypes.c_int(METHODS.index(method)), *[ctypes.byref(x) for x in out])
    if err != 0:
        raise RuntimeError("%s block query failed with cudaError %d" % (name, err))
    return tuple(x.value for x in out)


def fwd_block(kind, method):
    """A forward kernel's block for ``method`` (``_block``), from
    csrc/<kind>_fwd.cu."""
    return _block(KINDS[kind].fwd, method)


def bwd_block(kind, method):
    """A backward kernel's block for ``method`` (``_block``), from
    csrc/<kind>_bwd.cu."""
    return _block(KINDS[kind].bwd, method)


def _integrate_cuda(packed, y0_cols, times, method):
    """dr_fwd: [T, 8, R]."""
    return kind_fwd("dr", None, packed, y0_cols, times, method)


def _integrate_prec_cuda(wmat, packed, y0_cols, times, method):
    """dr_prec_fwd: [T, 12, R]."""
    return kind_fwd("dr_prec", wmat, packed, y0_cols, times, method)


def dr_bwd(packed, times, traj, g, method):
    """Launch csrc/dr_bwd.cu: (dc [23, R], dy0 [8, R]) (``kind_bwd``)."""
    return kind_bwd("dr", None, packed, times, traj, g, method)[1:]


def dr_prec_bwd(wmat, packed, times, traj, g, method):
    """Launch csrc/dr_prec_bwd.cu: (dW [8, 10], dc [23, R], dy0 [12, R])."""
    return kind_bwd("dr_prec", wmat, packed, times, traj, g, method)


def relay_bwd(packed, times, traj, g, method):
    """Launch csrc/relay_bwd.cu: (dc [29, R], dy0 [12, R])."""
    return kind_bwd("relay", None, packed, times, traj, g, method)[1:]


def relay_prec_bwd(wmat, packed, times, traj, g, method):
    """Launch csrc/relay_prec_bwd.cu: (dW [8, 14], dc [29, R], dy0 [16, R])."""
    return kind_bwd("relay_prec", wmat, packed, times, traj, g, method)


def degrader_bwd(packed, times, traj, g, method):
    """Launch csrc/degrader_bwd.cu: (dc [28, R], dy0 [11, R])."""
    return kind_bwd("degrader", None, packed, times, traj, g, method)[1:]


def degrader_prec_bwd(wmat, packed, times, traj, g, method):
    """Launch csrc/degrader_prec_bwd.cu: (dW [8, 13], dc [28, R], dy0 [15, R])."""
    return kind_bwd("degrader_prec", wmat, packed, times, traj, g, method)


class _KindIntegrate(torch.autograd.Function):
    """(kind, [8, 2 + NS] (or, with a fold axis, [F, 8, 2 + NS]) weights or
    None, [NC, R] constants, [S, R] y0, [T] times, method) -> [T, S, R]
    trajectory, differentiable in the weights, the constants and y0 (the TPU
    kernel's ``_integrate_padded`` / ``_integrate_padded_w`` custom VJPs).
    CUDA tensors launch the kind's forward and backward kernels; CPU tensors
    run the plain versions."""

    @staticmethod
    def forward(ctx, kind, wmat, packed, y0_cols, times, method):
        if packed.device.type == "cuda":
            traj = kind_fwd(kind, wmat, packed, y0_cols, times, method)
        else:
            traj = _plain_fwd(kind, wmat, packed, y0_cols, times, method)
        ctx.kind, ctx.method = kind, method
        ctx.save_for_backward(wmat, packed, times, traj)
        return traj

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_traj):
        wmat, packed, times, traj = ctx.saved_tensors
        g = grad_traj.contiguous()
        bwd = kind_bwd if packed.device.type == "cuda" else _plain_bwd
        dw, dc, dy0 = bwd(ctx.kind, wmat, packed, times, traj, g, ctx.method)
        return None, dw, dc, dy0, None, None


# --------------------------------------------------------------------------- #
# Public wrappers
# --------------------------------------------------------------------------- #
def _pack(constants, y0, kind="dr"):
    """[B,K]-broadcastable constants -> [NC, R] in the kind's order;
    y0[B,K,S] -> [S, R]."""
    k = KINDS[kind]
    B, K, S = y0.shape
    if S != k.n_states:
        raise ValueError("fused ODE %s: y0 has %d states, want %d" % (kind, S, k.n_states))
    R = B * K
    packed = torch.stack([torch.broadcast_to(constants[name], (B, K)).reshape(R)
                          for name in k.names])
    return packed, y0.reshape(R, S).t().contiguous()


def _unpack(out, B, K):
    """[T, S, R] -> [T, B, K, S] (a view, no copy)."""
    return out.view(out.shape[0], out.shape[1], B, K).permute(0, 2, 3, 1)


def _check_method(method):
    if method not in METHODS:
        raise ValueError("fused ODE: method %r not in %s" % (method, METHODS))


def _prec_wmat(prec_params):
    """Stack the NeuralPrecisions(n_hidden=0) weights into the kernels'
    single [8, 2 + NS] matrix operand (``Kind.wmat_shape``): rows 0..3
    ``prod``, 4..7 ``degr``; column 0 the bias, columns 1.. ``w.T`` over the
    input [t, species 0 .. NS-1].  ``prec_params``: {'prod': {'w': [1 + NS,
    4], 'b': [4]}, 'degr': {...}}.  Plain torch, so autograd carries dW back
    to the ``w`` and ``b`` leaves.  Leaves with a fold axis ([F, 1 + NS, 4],
    [F, 4]) give [F, 8, 2 + NS]."""
    return torch.cat(
        [torch.cat([prec_params[net]["b"][..., :, None],
                    prec_params[net]["w"].transpose(-1, -2)], dim=-1)
         for net in ("prod", "degr")],
        dim=-2,
    ).contiguous()


def _simulate(kind, constants, prec_params, y0, times, method):
    _check_method(method)
    B, K, _ = y0.shape
    if y0.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: no kernel for device %s" % (KINDS[kind].simulate, y0.device))
    packed, y0_cols = _pack(constants, y0, kind)
    wmat = _prec_wmat(prec_params) if KINDS[kind].prec else None
    return _unpack(_KindIntegrate.apply(kind, wmat, packed, y0_cols, times.contiguous(), method),
                   B, K)


def _simulate_plain(kind, constants, prec_params, y0, times, method):
    _check_method(method)
    B, K, _ = y0.shape
    packed, y0_cols = _pack(constants, y0, kind)
    wmat = _prec_wmat(prec_params) if KINDS[kind].prec else None
    return _unpack(_plain_fwd(kind, wmat, packed, y0_cols, times, method), B, K)


def dr_constant_simulate(constants, y0, times, method="midpoint"):
    """Fused fixed-grid integration of dr_constant, differentiable in the
    constants and y0.

    ``constants``: dict name -> [B, K]-broadcastable float32 tensors (the 23
    ``DR_CONST_NAMES``); ``y0``: [B, K, 8]; ``times``: [T].  Returns the
    trajectory [T, B, K, 8] (the JAX package's layout).  CPU tensors take the
    plain PyTorch versions; CUDA tensors launch csrc/dr_fwd.cu, and
    csrc/dr_bwd.cu when the gradient is taken."""
    return _simulate("dr", constants, None, y0, times, method)


def dr_constant_simulate_plain(constants, y0, times, method="midpoint"):
    """Plain PyTorch version of ``dr_constant_simulate`` on any device."""
    return _simulate_plain("dr", constants, None, y0, times, method)


def dr_constant_precisions_simulate(constants, prec_params, y0, times, method="midpoint"):
    """Fused integration of dr_constant_precisions (8 species + 4 learned
    precisions; NeuralPrecisions with n_hidden=0, tanh, non-inverse, the
    configuration of specs/*_precisions*.yaml), differentiable in the
    constants, the precision nets' params and y0.

    ``prec_params``: {'prod', 'degr'} -> {'w': [9, 4], 'b': [4]}; ``y0``:
    [B, K, 12]; the rest as ``dr_constant_simulate``.  Returns [T, B, K, 12].
    CPU tensors take the plain versions; CUDA tensors launch
    csrc/dr_prec_fwd.cu, and csrc/dr_prec_bwd.cu when the gradient is taken."""
    return _simulate("dr_prec", constants, prec_params, y0, times, method)


def dr_constant_precisions_simulate_plain(constants, prec_params, y0, times, method="midpoint"):
    """Plain PyTorch version of ``dr_constant_precisions_simulate``."""
    return _simulate_plain("dr_prec", constants, prec_params, y0, times, method)


def relay_constant_simulate(constants, y0, times, method="midpoint"):
    """Fused integration of the 12-state relay_constant family (the 29
    ``RELAY_CONST_NAMES``; ``y0`` [B, K, 12]); otherwise as
    ``dr_constant_simulate``, through csrc/relay_fwd.cu and relay_bwd.cu."""
    return _simulate("relay", constants, None, y0, times, method)


def relay_constant_simulate_plain(constants, y0, times, method="midpoint"):
    return _simulate_plain("relay", constants, None, y0, times, method)


def relay_constant_precisions_simulate(constants, prec_params, y0, times, method="midpoint"):
    """Fused relay_constant_precisions: 12 species + 4 learned precisions
    whose nets read [t, the 12 species] (``w``: [13, 4]); ``y0`` [B, K, 16];
    otherwise as ``dr_constant_precisions_simulate``, through
    csrc/relay_prec_fwd.cu and relay_prec_bwd.cu."""
    return _simulate("relay_prec", constants, prec_params, y0, times, method)


def relay_constant_precisions_simulate_plain(constants, prec_params, y0, times,
                                             method="midpoint"):
    return _simulate_plain("relay_prec", constants, prec_params, y0, times, method)


def degrader_constant_simulate(constants, y0, times, method="midpoint"):
    """Fused integration of the 11-state degrader_constant family (the 28
    ``DEGRADER_CONST_NAMES``; ``y0`` [B, K, 11]), through
    csrc/degrader_fwd.cu and degrader_bwd.cu."""
    return _simulate("degrader", constants, None, y0, times, method)


def degrader_constant_simulate_plain(constants, y0, times, method="midpoint"):
    return _simulate_plain("degrader", constants, None, y0, times, method)


def degrader_constant_precisions_simulate(constants, prec_params, y0, times, method="midpoint"):
    """Fused degrader_constant_precisions: 11 species + 4 learned
    precisions (``w``: [12, 4]); ``y0`` [B, K, 15]; through
    csrc/degrader_prec_fwd.cu and degrader_prec_bwd.cu."""
    return _simulate("degrader_prec", constants, prec_params, y0, times, method)


def degrader_constant_precisions_simulate_plain(constants, prec_params, y0, times,
                                                method="midpoint"):
    return _simulate_plain("degrader_prec", constants, prec_params, y0, times, method)


#: kernel -> the function whose ``launches`` attribute counts its launches
#: since the count was last set to 0: the forward kernels' on the kinds'
#: public wrappers, the backward kernels' on their launch functions
COUNTERS = {}
for _k in KINDS.values():
    COUNTERS[_k.fwd] = globals()[_k.simulate]
    COUNTERS[_k.bwd] = globals()[_k.bwd]
for _fn in COUNTERS.values():
    _fn.launches = 0
del _k, _fn


def simulate_kind(kind, constants, y0, times, method="midpoint", prec_params=None):
    """Family dispatcher used by OdeModel's fused route; ``prec_params`` are
    the precision nets' params of the ``*_prec`` kinds.  The kind's wrapper
    is looked up when called, so that a test may spy on it."""
    if kind not in KINDS:
        raise ValueError("no fused kernel kind %r (kinds: %s)" % (kind, ", ".join(KINDS)))
    fn = globals()[KINDS[kind].simulate]
    if KINDS[kind].prec:
        return fn(constants, prec_params, y0, times, method=method)
    return fn(constants, y0, times, method=method)
