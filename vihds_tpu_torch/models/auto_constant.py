"""Autofluorescence control device: 4 species (OD, RFP, F530, F480), and the
``_precisions`` variant with 4 learned-precision ODE states
(``vihds_tpu.models.auto_constant`` in PyTorch)."""

import torch

from vihds_tpu_torch.models.base import ConstantPrecisions, NeuralPrecisions, OdeModel

SPECIES = ["OD", "RFP", "F530", "F480"]


class Auto_Constant(OdeModel):
    version = 1

    def __init__(self, config):
        super().__init__(config)
        self.precisions = ConstantPrecisions(["prec_x", "prec_rfp", "prec_yfp", "prec_cfp"])
        self.species = list(SPECIES)
        self.n_species = 4

    def _mech_cols(self, theta):
        zero = torch.zeros_like(theta["init_x"])
        return [theta["init_x"], theta["init_rfp"], zero, zero]

    def initialize_state(self, params, theta, treatments, n_batch, n_iwae):
        return torch.stack(torch.broadcast_tensors(*self._mech_cols(theta)), dim=-1)

    def make_rhs(self, params, theta, treatments, dev_1hot):
        r = torch.clamp(theta["r"], 0.0, 4.0)
        K = torch.clamp(theta["K"], 0.0, 4.0)
        tlag, rc = theta["tlag"], theta["rc"]
        drfp = torch.clamp(theta["drfp"], 1e-12, 2.0)
        a530, a480 = theta["a530"], theta["a480"]
        prec_params = params.get("precisions", {})
        dynamic = self.precisions.dynamic

        def rhs(t, state):
            x, rfp, f530, f480 = [state[..., i] for i in range(4)]
            gr = r * torch.sigmoid(4.0 * (t - tlag))
            gamma = gr * (1.0 - x / K)
            d_x = gamma * x
            d_rfp = rc - (gamma + drfp) * rfp
            d_f530 = rc * a530 - gamma * f530
            d_f480 = rc * a480 - gamma * f480
            dX = torch.stack([d_x, d_rfp, d_f530, d_f480], dim=-1)
            if dynamic:
                dV = self.precisions.rhs(prec_params, t, state, None)
                return torch.cat([dX, dV], dim=-1)
            return dX

        return rhs

    def observe(self, x_states, theta):
        """4-state map: OD, OD*RFP, OD*F530, OD*F480."""
        x = x_states
        return torch.stack(
            [
                x[:, :, 0, :],
                x[:, :, 0, :] * x[:, :, 1, :],
                x[:, :, 0, :] * x[:, :, 2, :],
                x[:, :, 0, :] * x[:, :, 3, :],
            ],
            dim=2,
        )


class Auto_Constant_Precisions(Auto_Constant):
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
