"""Degrader device: 11 species, the double receiver's 8 plus the lactonase
AiiA, driven by an arabinose (PBAD) input, and the C6 / C12 it degrades; and
the ``_precisions`` variant with 4 learned-precision ODE states whose nets
read all 11."""

import torch

from vihds_tpu_torch.models.base import (
    ConstantPrecisions,
    NeuralPrecisions,
    OdeModel,
    power,
    rhs_from_cols,
    split_treatments,
    with_prec_state0,
)
from vihds_tpu_torch.ops.fused_ode import _degrader_rhs_cols

SPECIES = ["OD", "RFP", "YFP", "CFP", "F530", "F480", "LuxR", "LasR", "AiiA", "C6", "C12"]


def _degrader_constants(theta, treatments):
    """Clip/transform thetas into the per-sample constants the RHS uses,
    with the per-row PBAD, rC6 and rC12 of the three treatments."""
    c6, c12, ara = split_treatments(treatments, 3)
    c = {}
    c["r"] = torch.clamp(theta["r"], 0.0, 4.0)
    c["K"] = torch.clamp(theta["K"], 0.0, 4.0)
    c["tlag"] = theta["tlag"]
    c["rc"] = theta["rc"]
    c["a530"] = theta["a530"]
    c["a480"] = theta["a480"]
    c["drfp"] = torch.clamp(theta["drfp"], 1e-12, 2.0)
    c["dyfp"] = torch.clamp(theta["dyfp"], 1e-12, 2.0)
    c["dcfp"] = torch.clamp(theta["dcfp"], 1e-12, 2.0)
    c["dR"] = torch.clamp(theta["dR"], 1e-12, 5.0)
    c["dS"] = torch.clamp(theta["dS"], 1e-12, 5.0)
    for k in ("e76", "e81", "aCFP", "aYFP", "KGR_76", "KGS_76", "KGR_81", "KGS_81", "aR", "aS",
              "aI", "daiiA", "eA", "KAra"):
        c[k] = theta[k]
    nA = torch.clamp(theta["nA"], 0.5, 3.0)
    c["PBAD"] = (power(ara, nA) + c["eA"] * power(c["KAra"], nA)) / (
        power(ara, nA) + power(c["KAra"], nA)
    )
    c["rC6"] = theta["dA6"] * c6
    c["rC12"] = theta["dA12"] * c12
    nR = torch.clamp(theta["nR"], 0.5, 3.0)
    nS = torch.clamp(theta["nS"], 0.5, 3.0)
    lb, ub = 1e-12, 1e0
    KR6 = torch.clamp(theta["KR6"], lb, ub)
    KR12 = torch.clamp(theta["KR12"], lb, ub)
    KS6 = torch.clamp(theta["KS6"], lb, ub)
    KS12 = torch.clamp(theta["KS12"], lb, ub)
    c["fracLuxR"] = (power(KR6 * c6, nR) + power(KR12 * c12, nR)) / power(
        1.0 + KR6 * c6 + KR12 * c12, nR
    )
    c["fracLasR"] = (power(KS6 * c6, nS) + power(KS12 * c12, nS)) / power(
        1.0 + KS6 * c6 + KS12 * c12, nS
    )
    return c


class Degrader_Constant(OdeModel):
    version = 1

    def __init__(self, config):
        super().__init__(config)
        self.precisions = ConstantPrecisions(["prec_x", "prec_rfp", "prec_yfp", "prec_cfp"])
        self.species = list(SPECIES)
        self.n_species = 11

    def _mech_state0(self, theta, treatments, n_batch, n_iwae):
        zero = torch.zeros_like(theta["init_x"])
        c6, c12, _ara = split_treatments(treatments, 3)
        cols = [theta["init_x"], theta["init_rfp"], theta["init_yfp"], theta["init_cfp"], zero,
                zero, theta["init_luxR"], theta["init_lasR"], theta["init_aiiA"], c6, c12]
        return torch.stack([torch.broadcast_to(col, (n_batch, n_iwae)) for col in cols], dim=-1)

    def initialize_state(self, params, theta, treatments, n_batch, n_iwae):
        return self._mech_state0(theta, treatments, n_batch, n_iwae)

    # fused route (vihds_tpu_torch/ops/fused_ode.py; routing in OdeModel.simulate)
    pallas_kinds = ("degrader", "degrader_prec")

    def _pallas_constants(self, theta, treatments):
        return _degrader_constants(theta, treatments)

    def make_rhs(self, params, theta, treatments, dev_1hot):
        """The generic solver's RHS: the fused kernels' right-hand side
        (``fused_ode._degrader_rhs_cols``) on the state-major view."""
        return rhs_from_cols(_degrader_rhs_cols, _degrader_constants(theta, treatments), 11,
                             self.precisions, params.get("precisions", {}))


class Degrader_Constant_Precisions(Degrader_Constant):
    def __init__(self, config):
        super().__init__(config)
        self.precisions = NeuralPrecisions(
            self.n_species, config.params.n_hidden_decoder_precisions, 4
        )

    def initialize_state(self, params, theta, treatments, n_batch, n_iwae):
        return with_prec_state0(self._mech_state0(theta, treatments, n_batch, n_iwae), theta,
                                n_batch, n_iwae)
