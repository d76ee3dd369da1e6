"""Amortised posterior q(theta | x, d): encoder trunk + per-tier heads.

The trunk is valid Conv1d -> stride-1 AvgPool1d -> Linear -> tanh over the
first-differenced observations; all heads of one tier are one stacked matmul
per free-parameter kind (mu / log-prec), as in ``vihds_tpu.nn.encoder``.
"""

import math

import torch

from vihds_tpu_torch.nn import layers
from vihds_tpu_torch.prob.program import ParamProgram
from vihds_tpu_torch.prob.sites import KUMARASWAMY
from vihds_tpu_torch.utils.attrdict import AttrDict


def _tier_flags(sites_list):
    """(cond_treatments, cond_devices) for a tier (uniform across its sites)."""
    if not sites_list:
        return False, False
    t = sites_list[0]
    return bool(t.cond_treatments), bool(t.cond_devices)


class Encoder:
    """Static shape info + param init + apply."""

    def __init__(self, program: ParamProgram, data, params):
        """``data``: TimeSeriesDatasetPair; ``params``: settings.params."""
        self.program = program
        self.n_species = data.train.dataset.n_species
        self.n_times = data.train.dataset.n_times
        self.n_conditions = data.n_conditions
        self.depth = data.depth
        self.n_filters = params.n_filters
        self.filter_size = params.filter_size
        self.pool_size = params.pool_size
        self.n_hidden = params.n_hidden
        self.q_global_init = getattr(params, "q_global_init", "unit")
        if self.q_global_init not in ("prior", "unit"):
            raise ValueError("Unknown q_global_init %s" % self.q_global_init)
        if params.transfer_func != "tanh":
            raise ValueError("Unknown transfer_func %s" % params.transfer_func)

        n_obs = self.n_times - 1
        n_conv = n_obs - (self.filter_size - 1)
        n_pool = n_conv - (self.pool_size - 1)
        self.n_flat = n_pool * self.n_filters

        sites = program.sites
        self.n_local = len(sites.local)
        self.n_gc = len(sites.global_cond)
        self.n_global = len(sites.global_)
        self.loc_cond_treat, self.loc_cond_dev = _tier_flags(sites.local)
        self.gc_cond_treat, self.gc_cond_dev = _tier_flags(sites.global_cond)
        # local heads always see the encoded data
        self.d_local = (
            self.n_hidden
            + (self.n_conditions if self.loc_cond_treat else 0)
            + (self.depth if self.loc_cond_dev else 0)
        )
        self.d_gc = (self.n_conditions if self.gc_cond_treat else 0) + (
            self.depth if self.gc_cond_dev else 0
        )

    # ---------------------------------------------------------------- params
    def init_params(self, generator):
        p = {
            "conv": layers.conv1d_init(generator, self.n_species, self.n_filters, self.filter_size),
            "lin": {
                "w": torch.nn.init.orthogonal_(
                    torch.empty(self.n_flat, self.n_hidden), generator=generator
                ),
                "b": torch.empty(self.n_hidden).uniform_(
                    -1.0 / math.sqrt(self.n_flat), 1.0 / math.sqrt(self.n_flat),
                    generator=generator,
                ),
            },
        }
        if self.n_local:
            p["loc_mu"] = layers.linear_init(generator, self.d_local, self.n_local, use_bias=True)
            p["loc_lp"] = layers.linear_init(generator, self.d_local, self.n_local, use_bias=True)
        if self.n_gc:
            # no bias for global-conditioned heads
            p["gc_mu"] = layers.linear_init(generator, self.d_gc, self.n_gc, use_bias=False)
            p["gc_lp"] = layers.linear_init(generator, self.d_gc, self.n_gc, use_bias=False)
        if self.n_global:
            # free scalars initialised from the spec; "unit" starts the
            # normal-family log-precisions at 0
            g_sites = self.program.sites.global_
            p["glob_mu"] = torch.tensor([s.init_free[0] for s in g_sites], dtype=torch.float32)
            p["glob_lp"] = torch.tensor(
                [
                    s.init_free[1]
                    if (self.q_global_init == "prior" or s.kind == KUMARASWAMY)
                    else 0.0
                    for s in g_sites
                ],
                dtype=torch.float32,
            )
        return p

    # ----------------------------------------------------------------- apply
    def trunk(self, p, observations):
        """First-difference the observations, then conv/pool/linear/tanh."""
        delta_obs = observations[:, :, 1:] - observations[:, :, :-1]
        x = layers.conv1d_apply(p["conv"], delta_obs)
        x = layers.avgpool1d(x, self.pool_size)
        x = x.reshape(x.shape[0], -1)
        return torch.tanh(layers.linear_apply(p["lin"], x))

    def __call__(self, p, data):
        """data: batch AttrDict of tensors -> q {mu, prec, logprec} [B, n_theta].

        A batch of ``merge: false`` data carries ``enc_observations``, its
        series snapped onto the shortest grid the trunk was built for, while
        ``observations`` stays on the file's native grid for the likelihood."""
        obs = data["enc_observations"] if "enc_observations" in data else data.observations
        B = obs.shape[0]
        encoded = self.trunk(p, obs)

        parts_mu, parts_lp = [], []
        if self.n_local:
            xs = [encoded]
            if self.loc_cond_treat:
                xs.append(data.inputs)
            if self.loc_cond_dev:
                xs.append(data.dev_1hot)
            x_loc = torch.cat(xs, dim=1)
            parts_mu.append(layers.linear_apply(p["loc_mu"], x_loc))
            parts_lp.append(layers.linear_apply(p["loc_lp"], x_loc))
        if self.n_gc:
            xs = []
            if self.gc_cond_treat:
                xs.append(data.inputs)
            if self.gc_cond_dev:
                xs.append(data.dev_1hot)
            x_gc = torch.cat(xs, dim=1)
            parts_mu.append(layers.linear_apply(p["gc_mu"], x_gc))
            parts_lp.append(layers.linear_apply(p["gc_lp"], x_gc))
        if self.n_global:
            parts_mu.append(p["glob_mu"][None, :].expand(B, self.n_global))
            parts_lp.append(p["glob_lp"][None, :].expand(B, self.n_global))
        n_const = len(self.program.sites.constant)
        if n_const:
            cvals = self.program.const_value[self.program.constant_slice]
            parts_mu.append(torch.as_tensor(cvals, device=obs.device)[None, :].expand(B, n_const))
            parts_lp.append(torch.zeros((B, n_const), dtype=torch.float32, device=obs.device))

        mu = torch.cat(parts_mu, dim=1)
        logprec = torch.cat(parts_lp, dim=1)
        # Kumaraswamy (a, b) ride the (mu, prec) slots and are both positive
        if self.program.is_kumaraswamy.any():
            is_k = torch.as_tensor(self.program.is_kumaraswamy, device=mu.device)
            mu = torch.where(is_k, torch.exp(mu), mu)
        return AttrDict(mu=mu, logprec=logprec, prec=torch.exp(logprec))
