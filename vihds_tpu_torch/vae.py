"""End-to-end VAE: encoder -> sample -> clip -> condition -> integrate -> observe.

Functions of an explicit param dict, as in ``vihds_tpu.vae``; ``forward``
serves and evaluates, ``forward_logprob`` is the training objective's
forward.  The latent
draws ``u ~ N(0, 1)`` come from the caller (an explicit ``torch.Generator``
upstream), so tests can hand both packages the same draws.
"""

import torch

from vihds_tpu_torch import models, parallel
from vihds_tpu_torch.nn.encoder import Encoder
from vihds_tpu_torch.ops.logprob import log_prob_observations
from vihds_tpu_torch.prob import ParamProgram
from vihds_tpu_torch.utils import resolve_device
from vihds_tpu_torch.utils.attrdict import AttrDict


def params_to(params, device):
    """Move a (nested dict) param tree of tensors to ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


class VAE:
    """Static model assembly; all state lives in the params dict."""

    def __init__(self, settings, data, program: ParamProgram):
        self.program = program
        self.encoder = Encoder(program, data, settings.params)
        if settings.model not in models.LOOKUP:
            raise ValueError(
                "Unknown model %r; available: %s"
                % (settings.model, ", ".join(sorted(models.LOOKUP)))
            )
        self.ode_model = models.LOOKUP[settings.model](settings)
        # single-device specs disable decoder conditioning
        self.condition_on_device = settings.data.device_depth > 1
        if not self.condition_on_device:
            self.ode_model.conditioned_params = ()
        self.n_theta = program.n_theta
        self.state_names = self.ode_model.species
        self.use_laplace = self.ode_model.use_laplace

    def init_params(self, generator, device="cuda"):
        """Fresh params drawn from the CPU ``generator``, moved to ``device``."""
        device = resolve_device(device)
        params = {
            "enc": self.encoder.init_params(generator),
            "dec": self.ode_model.init_params(generator),
        }
        return params_to(params, device)

    def sample_u(self, generator, n_batch, n_samples, device):
        """Standard-normal draws u[B, K, n_theta] from ``generator`` (on its
        own device), placed on ``device``.  Over several ranks every rank
        draws the whole u; the decoder block takes its rows and samples
        (``forward_sharded``)."""
        u = torch.randn(
            (n_batch, n_samples, self.n_theta), generator=generator, device=generator.device
        )
        return u.to(device)

    def forward(self, params, batch, u, eval_mode=False):
        """One forward pass.  ``batch``: AttrDict of tensors (observations
        [B,S,T], inputs[B,C], dev_1hot[B,D], times[T]); ``u``: [B,K,n_theta].

        Returns AttrDict with x_states[B,K,S,T], x_predict[B,K,4,T],
        precisions (broadcastable to x_predict), theta (sampled),
        theta_clipped, theta_cond and q.  log q / log p score the SAMPLED
        theta; the clipped theta feeds only the decoder."""
        q = self.encoder(params["enc"], batch)
        theta = self.program.sample(q, u)
        clipped = self.program.clip(theta, stddevs=4)
        decoded = self.decode(params, clipped, batch, eval_mode=eval_mode)
        decoded["theta"] = theta
        decoded["q"] = q
        return decoded

    def decode(self, params, theta_clipped, batch, eval_mode=False):
        """Decoder-only pass for given clipped theta draws [B,K,n_theta]:
        condition -> simulate -> expand precisions -> observe.  Also the
        counterfactual serving path (``predict.counterfactual``)."""
        th = self.condition(params, theta_clipped, batch)
        x_states, x_predict, precisions = self.integrate(
            params["dec"], th, batch, theta_clipped.shape[1], eval_mode=eval_mode)
        return AttrDict(
            x_states=x_states,
            x_predict=x_predict,
            precisions=precisions,
            theta_clipped=theta_clipped,
            theta_cond=th,
        )

    def condition(self, params, theta_clipped, batch):
        """The clipped draws as named columns, device-conditioned."""
        th = self.program.theta_dict(theta_clipped)
        if self.condition_on_device:
            th = self.ode_model.condition_theta(params["dec"], th, batch.dev_1hot)
        return th

    def integrate(self, dec, th, batch, n_iwae, eval_mode=False):
        """The decoder block on conditioned draws ``th``: simulate -> expand
        precisions -> observe; returns (x_states, x_predict, precisions)."""
        x_solution = self.ode_model.simulate(
            dec, th, batch.times, batch.inputs, batch.dev_1hot, n_iwae=n_iwae,
            eval_mode=eval_mode,
        )
        x_states, precisions = self.ode_model.expand_precisions(
            dec, th, batch.times.shape[0], x_solution
        )
        return x_states, self.ode_model.observe(x_states, th), precisions

    def likelihood(self, dec, th, batch, n_iwae):
        """log p(observations | th) by species [B, K, S] through the training
        route: the online fold route where the solver allows it, else the
        trajectory (the fused kernels under ``pallas_<method>``)."""
        if self.ode_model.supports_fold():
            return self.ode_model.simulate_logprob(
                dec, th, batch.times, batch.inputs, batch.dev_1hot, n_iwae=n_iwae,
                observations=batch.observations, use_laplace=self.use_laplace,
            )
        _, x_predict, precisions = self.integrate(dec, th, batch, n_iwae)
        return log_prob_observations(x_predict, batch.observations, precisions, self.use_laplace)

    def forward_sharded(self, params, batch, u, mesh):
        """The training forward over the ranks of ``mesh``: encode ->
        sample -> clip -> condition on the whole batch and all draws on every
        rank, then the decoder block (``likelihood``) on this rank's rows and
        samples (``parallel.shard_block``), assembled whole.  Returns
        AttrDict with log_p_by_species [B, K, S], theta and q, as
        ``forward_logprob``."""
        q = self.encoder(params["enc"], batch)
        theta = self.program.sample(q, u)
        th = self.condition(params, self.program.clip(theta, stddevs=4), batch)
        log_p_by_species = parallel.shard_block(mesh, self.likelihood, params["dec"], th, batch,
                                                u.shape[1])
        return AttrDict(log_p_by_species=log_p_by_species, theta=theta, q=q)

    def forward_logprob(self, params, batch, u):
        """Training-objective forward: encode -> sample -> clip -> condition
        -> integrate with the observation log-likelihood accumulated online
        (``OdeModel.simulate_logprob``), no [B,K,S,T] trajectory.  Returns
        AttrDict with log_p_by_species[B,K,4], theta (sampled: what log q and
        log p score) and q.  The same latent pipeline as ``forward``."""
        q = self.encoder(params["enc"], batch)
        theta = self.program.sample(q, u)
        th = self.program.theta_dict(self.program.clip(theta, stddevs=4))
        if self.condition_on_device:
            th = self.ode_model.condition_theta(params["dec"], th, batch.dev_1hot)
        log_p_by_species = self.ode_model.simulate_logprob(
            params["dec"],
            th,
            batch.times,
            batch.inputs,
            batch.dev_1hot,
            n_iwae=u.shape[1],
            observations=batch.observations,
            use_laplace=self.use_laplace,
        )
        return AttrDict(log_p_by_species=log_p_by_species, theta=theta, q=q)

