"""Constitutive double-reporter device: 6 species, and the ``_precisions``
variant with 4 learned-precision ODE states
(``vihds_tpu.models.prpr_constant`` in PyTorch)."""

import torch

from vihds_tpu_torch.models.base import ConstantPrecisions, NeuralPrecisions, OdeModel

SPECIES = ["OD", "RFP", "YFP", "CFP", "F530", "F480"]


class PRPR_Constant(OdeModel):
    version = 1

    def __init__(self, config):
        super().__init__(config)
        self.precisions = ConstantPrecisions(["prec_x", "prec_rfp", "prec_yfp", "prec_cfp"])
        self.species = list(SPECIES)
        self.n_species = 6

    def _mech_cols(self, theta):
        zero = torch.zeros_like(theta["init_x"])
        return [theta["init_x"], theta["init_rfp"], theta["init_yfp"], theta["init_cfp"], zero,
                zero]

    def initialize_state(self, params, theta, treatments, n_batch, n_iwae):
        return torch.stack(torch.broadcast_tensors(*self._mech_cols(theta)), dim=-1)

    def make_rhs(self, params, theta, treatments, dev_1hot):
        r = torch.clamp(theta["r"], 0.0, 4.0)
        K = torch.clamp(theta["K"], 0.0, 4.0)
        tlag, rc = theta["tlag"], theta["rc"]
        a530, a480 = theta["a530"], theta["a480"]
        drfp = torch.clamp(theta["drfp"], 1e-12, 2.0)
        dyfp = torch.clamp(theta["dyfp"], 1e-12, 2.0)
        dcfp = torch.clamp(theta["dcfp"], 1e-12, 2.0)
        aCFP, aYFP = theta["aCFP_PR"], theta["aYFP_PR"]
        prec_params = params.get("precisions", {})
        dynamic = self.precisions.dynamic

        def rhs(t, state):
            x, rfp, yfp, cfp, f530, f480 = [state[..., i] for i in range(6)]
            gr = r * torch.sigmoid(4.0 * (t - tlag))
            gamma = gr * (1.0 - x / K)
            d_x = gamma * x
            d_rfp = rc - (gamma + drfp) * rfp
            d_yfp = rc * aYFP - (gamma + dyfp) * yfp
            d_cfp = rc * aCFP - (gamma + dcfp) * cfp
            d_f530 = rc * a530 - gamma * f530
            d_f480 = rc * a480 - gamma * f480
            dX = torch.stack([d_x, d_rfp, d_yfp, d_cfp, d_f530, d_f480], dim=-1)
            if dynamic:
                dV = self.precisions.rhs(prec_params, t, state, None)
                return torch.cat([dX, dV], dim=-1)
            return dX

        return rhs


class PRPR_Constant_Precisions(PRPR_Constant):
    def __init__(self, config):
        super().__init__(config)
        self.precisions = NeuralPrecisions(
            self.n_species, config.params.n_hidden_decoder_precisions, 4
        )

    def initialize_state(self, params, theta, treatments, n_batch, n_iwae):
        cols = self._mech_cols(theta) + [
            theta["init_prec_x"], theta["init_prec_rfp"], theta["init_prec_yfp"],
            theta["init_prec_cfp"],
        ]
        return torch.stack(torch.broadcast_tensors(*cols), dim=-1)
