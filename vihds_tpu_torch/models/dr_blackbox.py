"""Black-box double-receiver: a neural-network RHS over the 4 observed and
``n_latent_species`` latent species, with learned precisions as 4 more ODE
states.

Latent inputs z (local), x (global) and y (global-conditioned, offset by a
learned linear map of the device one-hot) reach the nets as per-sample
constants beside the treatments (left in log1p space) and the device
one-hot.  ``solver`` / ``eval_solver: pallas_<method>`` routes through the
fused black-box kernels (``ops/fused_blackbox.py``) where they cover the
configuration, else the same fixed-grid method on the generic solver.
"""

import torch

from vihds_tpu_torch.models.base import NeuralPrecisions, NeuralStates, OdeModel
from vihds_tpu_torch.nn import layers
from vihds_tpu_torch.utils import default_get_value

SPECIES = ["OD", "RFP", "YFP", "CFP"]


class DR_Blackbox(OdeModel):
    def __init__(self, config):
        super().__init__(config)
        self.n_x = config.params.n_x
        self.n_y = config.params.n_y
        self.n_z = config.params.n_z
        self.n_latents = self.n_x + self.n_y + self.n_z
        self.n_species = 4
        self.n_latent_species = config.params.n_latent_species
        self.n_states = self.n_species + self.n_latent_species
        n_inputs = self.n_states + self.n_latents + self.n_treatments + self.device_depth
        self.precisions = NeuralPrecisions(
            n_inputs, config.params.n_hidden_decoder_precisions, 4, activation="relu"
        )
        self.species = list(SPECIES)
        self.n_hidden = config.params.n_hidden_decoder
        self.init_latent_species = default_get_value(config.params, "init_latent_species", 0.001)
        self.init_prec = default_get_value(config.params, "init_prec", 0.00001)
        self.neural_states = NeuralStates(n_inputs, self.n_hidden, self.n_states, self.n_latents)

    def init_params(self, generator):
        return {
            "offset": layers.linear_init(generator, self.device_depth, self.n_y, use_bias=True),
            "states": self.neural_states.init_params(generator),
            "precisions": self.precisions.init_params(generator),
        }

    def condition_theta(self, params, theta, dev_1hot):
        """The y latents get a learned per-device offset, before the
        constants are built."""
        offset = layers.linear_apply(params["offset"], dev_1hot)  # [B, n_y]
        for i in range(self.n_y):
            name = "y%d" % (i + 1)
            theta[name] = theta[name] + offset[:, None, i]
        return theta

    def _constants(self, theta, treatments, dev_1hot, n_iwae):
        """[z.., x.., y.., treatments, devices] along the last axis: [B, K, NC].
        The treatments stay in log1p space."""
        names = (["z%d" % (i + 1) for i in range(self.n_z)]
                 + ["x%d" % (i + 1) for i in range(self.n_x)]
                 + ["y%d" % (i + 1) for i in range(self.n_y)])
        n_batch = treatments.shape[0]
        latents = torch.stack([torch.broadcast_to(theta[n], (n_batch, n_iwae)) for n in names],
                              dim=-1)
        tre = torch.broadcast_to(treatments[:, None, :], (n_batch, n_iwae, treatments.shape[1]))
        dev = torch.broadcast_to(dev_1hot[:, None, :], (n_batch, n_iwae, dev_1hot.shape[1]))
        return torch.cat([latents, tre, dev], dim=-1)

    def initialize_state(self, params, theta, treatments, n_batch, n_iwae):
        x0 = torch.stack(torch.broadcast_tensors(
            theta["init_x"], theta["init_rfp"], theta["init_yfp"], theta["init_cfp"]), dim=-1)
        x0 = torch.broadcast_to(x0, (n_batch, n_iwae, 4))
        h0 = torch.full((n_batch, n_iwae, self.n_latent_species), self.init_latent_species,
                        dtype=x0.dtype, device=x0.device)
        prec0 = torch.full((n_batch, n_iwae, 4), self.init_prec, dtype=x0.dtype,
                           device=x0.device)
        return torch.cat([x0, h0, prec0], dim=-1)

    def simulate(self, params, theta, times, treatments, dev_1hot, n_iwae, eval_mode=False,
                 folds=None):
        """x_states [B, K, S, T].  ``pallas_<method>`` runs through the fused
        black-box kernels when ``fused_blackbox.supported`` holds; anything
        else takes ``OdeModel.simulate``'s generic solver (with the same
        fixed-grid method for ``pallas_<method>``)."""
        from vihds_tpu_torch.ops import fused_blackbox

        method = self._solver_for(eval_mode)
        if not (method.startswith("pallas_") and fused_blackbox.supported(self)):
            return super().simulate(params, theta, times, treatments, dev_1hot, n_iwae, eval_mode,
                                    folds)
        y0 = self.initialize_state(params, theta, treatments, treatments.shape[0], n_iwae)
        constants = self._constants(theta, treatments, dev_1hot, n_iwae)
        sol = fused_blackbox.blackbox_simulate(params, constants, y0, times, self.n_states,
                                               method=method[len("pallas_"):])
        return sol.permute(1, 2, 3, 0)

    def make_rhs(self, params, theta, treatments, dev_1hot):
        n_iwae = theta["z1"].shape[1]
        constants = self._constants(theta, treatments, dev_1hot, n_iwae)
        states_params = params["states"]
        prec_params = params["precisions"]

        def rhs(t, state):
            dx = self.neural_states(states_params, state[..., :-4], constants)
            dv = self.precisions.rhs(prec_params, t, state, constants)
            return torch.cat([dx, dv], dim=-1)

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
