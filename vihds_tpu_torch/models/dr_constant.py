"""Double-receiver device models (the ICML 2019 headline model family).

8 mechanistic species (OD, RFP, YFP, CFP, F530, F480, LuxR, LasR), promoter
activities P76/P81, Hill-style fracLuxR/fracLasR input functions, logistic
growth with lag, device-conditioned aR/aS, the V2 crosstalk variant, and the
``*_precisions`` variants with 4 extra learned-precision ODE states.
"""

import torch

from vihds_tpu_torch.models.base import (
    ConstantPrecisions,
    NeuralPrecisions,
    OdeModel,
    power,
    split_treatments,
)

SPECIES = ["OD", "RFP", "YFP", "CFP", "F530", "F480", "LuxR", "LasR"]


def _dr_constants(theta, treatments, version):
    """Clip/transform thetas into the per-sample constants the RHS uses."""
    c6, c12 = split_treatments(treatments, 2)
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
    for k in ("e76", "e81", "aCFP", "aYFP", "KGR_76", "KGS_76", "KGR_81", "KGS_81", "aR", "aS"):
        c[k] = theta[k]
    nR = torch.clamp(theta["nR"], 0.5, 3.0)
    nS = torch.clamp(theta["nS"], 0.5, 3.0)
    lb, ub = 1e-12, 1e0
    if version == 1:
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
    elif version == 2:
        eS6 = torch.clamp(theta["eS6"], lb, ub)
        eR12 = torch.clamp(theta["eR12"], lb, ub)
        c["fracLuxR"] = power(c6, nR) + power(eR12 * c12, nR)
        c["fracLasR"] = power(eS6 * c6, nS) + power(c12, nS)
    else:
        raise ValueError("Unknown version of DR_Constant: %d" % version)
    return c


def _dr_species_rhs(c, t, state):
    """Mechanistic RHS over the 8 states of state[..., 8]."""
    x, rfp, yfp, cfp, f530, f480, luxR, lasR = state[..., :8].unbind(-1)

    gr = c["r"] * torch.sigmoid(4.0 * (t - c["tlag"]))
    gamma = gr * (1.0 - x / c["K"])

    boundLuxR = luxR * luxR * c["fracLuxR"]
    boundLasR = lasR * lasR * c["fracLasR"]
    P76 = (c["e76"] + c["KGR_76"] * boundLuxR + c["KGS_76"] * boundLasR) / (
        1.0 + c["KGR_76"] * boundLuxR + c["KGS_76"] * boundLasR
    )
    P81 = (c["e81"] + c["KGR_81"] * boundLuxR + c["KGS_81"] * boundLasR) / (
        1.0 + c["KGR_81"] * boundLuxR + c["KGS_81"] * boundLasR
    )

    d_x = gamma * x
    d_rfp = c["rc"] - (gamma + c["drfp"]) * rfp
    d_yfp = c["rc"] * c["aYFP"] * P81 - (gamma + c["dyfp"]) * yfp
    d_cfp = c["rc"] * c["aCFP"] * P76 - (gamma + c["dcfp"]) * cfp
    d_f530 = c["rc"] * c["a530"] - gamma * f530
    d_f480 = c["rc"] * c["a480"] - gamma * f480
    d_luxR = c["rc"] * c["aR"] - (gamma + c["dR"]) * luxR
    d_lasR = c["rc"] * c["aS"] - (gamma + c["dS"]) * lasR

    return torch.stack([d_x, d_rfp, d_yfp, d_cfp, d_f530, d_f480, d_luxR, d_lasR], dim=-1)


class DR_Constant(OdeModel):
    version = 1

    def __init__(self, config):
        super().__init__(config)
        self.precisions = ConstantPrecisions(["prec_x", "prec_rfp", "prec_yfp", "prec_cfp"])
        self.species = list(SPECIES)
        self.n_species = 8
        self.conditioned_params = ("aR", "aS")

    def initialize_state(self, params, theta, treatments, n_batch, n_iwae):
        zero = torch.zeros_like(theta["init_x"])
        cols = [
            theta["init_x"],
            theta["init_rfp"],
            theta["init_yfp"],
            theta["init_cfp"],
            zero,
            zero,
            theta["init_luxR"],
            theta["init_lasR"],
        ]
        return torch.stack(torch.broadcast_tensors(*cols), dim=-1)

    def make_rhs(self, params, theta, treatments, dev_1hot):
        c = _dr_constants(theta, treatments, self.version)
        prec_params = params.get("precisions", {})
        dynamic = self.precisions.dynamic

        def rhs(t, state):
            dX = _dr_species_rhs(c, t, state)
            if dynamic:
                dV = self.precisions.rhs(prec_params, t, state, None)
                return torch.cat([dX, dV], dim=-1)
            return dX

        return rhs

    # fused route (vihds_tpu_torch/ops/fused_ode.py; routing in OdeModel.simulate)
    pallas_kinds = ("dr", "dr_prec")

    def _pallas_constants(self, theta, treatments):
        return _dr_constants(theta, treatments, self.version)


class DR_Constant_V2(DR_Constant):
    version = 2


class DR_Constant_Precisions(DR_Constant):
    version = 1

    def __init__(self, config):
        super().__init__(config)
        self.precisions = NeuralPrecisions(
            self.n_species, config.params.n_hidden_decoder_precisions, 4
        )

    def initialize_state(self, params, theta, treatments, n_batch, n_iwae):
        zero = torch.zeros_like(theta["init_x"])
        cols = [
            theta["init_x"],
            theta["init_rfp"],
            theta["init_yfp"],
            theta["init_cfp"],
            zero,
            zero,
            theta["init_luxR"],
            theta["init_lasR"],
            theta["init_prec_x"],
            theta["init_prec_rfp"],
            theta["init_prec_yfp"],
            theta["init_prec_cfp"],
        ]
        return torch.stack(torch.broadcast_tensors(*cols), dim=-1)


class DR_Constant_Precisions_V2(DR_Constant_Precisions):
    version = 2
