"""Tiny 4-species logistic-growth toy model for smoke tests
(``vihds_tpu.models.debug`` in PyTorch)."""

import torch

from vihds_tpu_torch.models.base import ConstantPrecisions, OdeModel

SPECIES = ["OD", "RFP", "YFP", "CFP"]


class Debug_Constant(OdeModel):
    def __init__(self, config):
        super().__init__(config)
        self.precisions = ConstantPrecisions(["prec_x", "prec_rfp", "prec_yfp", "prec_cfp"])
        self.species = list(SPECIES)
        self.n_species = 4

    def initialize_state(self, params, theta, treatments, n_batch, n_iwae):
        zero = torch.zeros_like(theta["init_x"])
        cols = [theta["init_x"], zero, zero, zero]
        return torch.stack(torch.broadcast_tensors(*cols), dim=-1)

    def make_rhs(self, params, theta, treatments, dev_1hot):
        r = theta["r"]

        def rhs(t, state):
            x, rfp, yfp, cfp = [state[..., i] for i in range(4)]
            gamma = r * (1.0 - x)
            d_x = x * gamma
            d_rfp = 1.0 - (gamma + 1.0) * rfp
            d_yfp = 1.0 - (gamma + 1.0) * yfp
            d_cfp = 1.0 - (gamma + 1.0) * cfp
            return torch.stack([d_x, d_rfp, d_yfp, d_cfp], dim=-1)

        return rhs

    def observe(self, x_states, theta):
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
