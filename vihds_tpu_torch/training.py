"""The evaluation half of the training engine: IWAE terms, importance-weighted
posterior-predictive moments, and chunked evaluation of a host batch.

This is what serving (``vihds_tpu_torch.predict``) runs.  Training itself
(the optimizer, ``train_epoch``, the backward kernels) comes in a later
slice (ROADMAP queue 1, item 7).
"""

import math

import numpy as np
import torch

from vihds_tpu_torch.ops.logprob import log_prob_observations
from vihds_tpu_torch.results import Results
from vihds_tpu_torch.utils import resolve_device
from vihds_tpu_torch.utils.attrdict import AttrDict


def prior_as_q(program, device="cpu"):
    """The prior p as q-style tensors."""
    return program.prior_q(device)


def iwae_elbo_terms(program, out, batch, use_laplace):
    """log-weights and components: AttrDict with log_w[B,K],
    log_p_by_species[B,K,S], log_p_obs[B,K], log_q[B,K], log_p[B,K]."""
    log_p_by_species = log_prob_observations(
        out.x_predict, batch.observations, out.precisions, use_laplace
    )
    log_p_obs = log_p_by_species.sum(dim=2)
    log_q = program.log_prob(out.q, out.theta)
    log_p = program.log_prob(prior_as_q(program, out.theta.device), out.theta)
    log_w = log_p_obs + log_p - log_q
    return AttrDict(
        log_w=log_w,
        log_p_by_species=log_p_by_species,
        log_p_obs=log_p_obs,
        log_q=log_q,
        log_p=log_p,
    )


def masked_mean(x, mask):
    if mask is None:
        return x.mean()
    return (x * mask).sum() / mask.sum()


def iwae_elbo(terms, mask=None):
    """IWAE bound = mean_B(logsumexp_K(log w) - log K)."""
    n_iwae = terms.log_w.shape[1]
    lse = torch.logsumexp(terms.log_w, dim=1)
    return masked_mean(lse - math.log(n_iwae), mask)


def _importance_weighted_outputs(terms, out):
    """Importance-weighted predictive moments over the K axis."""
    lse = torch.logsumexp(terms.log_w, dim=1, keepdim=True)
    w = torch.exp(terms.log_w - lse)[:, :, None, None]  # [B,K,1,1]
    x_predict = out.x_predict
    precisions = out.precisions
    iw_predict_mu = torch.sum(w * x_predict, 1)
    iw_predict_std = torch.sqrt(
        torch.clamp(
            torch.sum(w * (x_predict ** 2 + 1.0 / precisions), 1) - iw_predict_mu ** 2, min=0.0
        )
    )
    iw_states = torch.sum(w * out.x_states, 1)
    iw_variance = torch.sum(w / precisions * torch.ones_like(x_predict), 1)
    return dict(
        iw_predict_mu=iw_predict_mu,
        iw_predict_std=iw_predict_std,
        iw_states=iw_states,
        iw_variance=iw_variance,
    )


def eval_step(model, program, params, batch, n_samples, generator=None, u=None, with_theta=True):
    """Evaluate one batch of tensors at K = ``n_samples`` draws, taken from
    ``generator`` or given as ``u[B, K, n_theta]``.  Returns a dict of
    tensors: per-item ELBO [B], the [B,K] IWAE terms, log_p_by_species,
    q's moments, the importance-weighted moments and (``with_theta``) the
    clipped theta draws [B,K,n_theta]."""
    B = batch.observations.shape[0]
    if u is None:
        u = model.sample_u(generator, B, n_samples, batch.observations.device)
    out = model.forward(params, batch, u, eval_mode=True)
    terms = iwae_elbo_terms(program, out, batch, model.use_laplace)
    res = dict(
        per_item_elbo=torch.logsumexp(terms.log_w, dim=1) - math.log(n_samples),
        log_w=terms.log_w,
        log_p_obs=terms.log_p_obs,
        log_q=terms.log_q,
        log_p=terms.log_p,
        log_p_by_species=terms.log_p_by_species,
        q_mu=out.q.mu,
        q_prec=out.q.prec,
        **_importance_weighted_outputs(terms, out),
    )
    if with_theta:
        res["theta_bkn"] = out.theta_clipped
    return res


def make_results(model, program, merged):
    """Merged eval arrays -> Results (the serving artifact)."""
    res = Results()
    res.init(
        model.state_names,
        program,
        merged.q_mu,
        merged.q_prec,
        merged.get("theta", np.zeros((program.n_theta, 0, 0), np.float32)),
        merged.elbo,
        {k: merged[k] for k in ("iw_predict_mu", "iw_predict_std", "iw_states", "iw_variance")},
    )
    return res


def batch_tensors(host, rows, times, device):
    """Rows ``rows`` of a host batch as float32 tensors on ``device``."""
    return AttrDict(
        observations=torch.as_tensor(host.observations[rows], dtype=torch.float32, device=device),
        inputs=torch.as_tensor(host.inputs[rows], dtype=torch.float32, device=device),
        dev_1hot=torch.as_tensor(host.dev_1hot[rows], dtype=torch.float32, device=device),
        times=times,
    )


class Training:
    """Holds what evaluation needs of a trained model: the settings, the
    program, the VAE and the chunk size ``n_batch``."""

    def __init__(self, settings, data, program, model):
        self.settings = settings
        self.program = program
        self.model = model
        self.n_batch = min(settings.params.n_batch, data.n_train)

    def evaluate(self, params, host, n_samples, generator, device="cuda", with_theta=True):
        """Evaluate a host batch (numpy observations[B,S,T] training-scaled,
        inputs[B,C] log1p, dev_1hot[B,D], times[T]) at K = ``n_samples``.

        Runs in chunks of ``n_batch`` rows; the last chunk is padded with row
        0 and the padding dropped afterwards (IWAE is exact under chunking).
        Returns (merged numpy arrays, Results)."""
        device = resolve_device(device)
        n = host.observations.shape[0]
        chunk = self.n_batch
        n_chunks = math.ceil(n / chunk)
        idx = np.concatenate([np.arange(n), np.zeros(n_chunks * chunk - n, int)])
        times = torch.as_tensor(host.times, dtype=torch.float32, device=device)
        parts = []
        with torch.no_grad():
            for rows in idx.reshape(n_chunks, chunk):
                batch = batch_tensors(host, rows, times, device)
                res = eval_step(
                    self.model, self.program, params, batch, n_samples,
                    generator=generator, with_theta=with_theta,
                )
                parts.append({k: v.cpu().numpy() for k, v in res.items()})
        merged = AttrDict((k, np.concatenate([p[k] for p in parts])[:n]) for k in parts[0])
        if with_theta:
            merged["theta"] = np.transpose(merged.pop("theta_bkn"), (2, 0, 1))  # [n_theta, B, K]
        merged["elbo"] = float(np.mean(merged["per_item_elbo"]))
        return merged, make_results(self.model, self.program, merged)
