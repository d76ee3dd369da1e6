"""The parameter sites of a spec and their distributions, in plain PyTorch.

A spec's ``params:`` tree names each latent parameter (a *site*) under one
of the tiers ``local``, ``global_conditioned``, ``global`` and ``constant``;
``shared`` holds templates that other sites name as their distribution.  The
reference supports the families the benchmark's configurations use: Normal,
LogNormal (``mu`` with ``sigma`` or ``prec``) and constants.  theta's columns
are the sites in tier order (local, global_conditioned, global, constant),
each tier in the spec's order.

Conventions (those of the published VI-HDS code): a LogNormal site is
exp of a Normal draw; log densities keep ``-log(2 pi)`` as their constant
(it cancels in the IWAE weight log p - log q); draws are clipped to the
prior's mean +- 4 standard deviations (in log space for LogNormal sites)
before they reach the decoder, while log q and log p score the draw itself.
"""

import math
from dataclasses import dataclass

import torch

TIERS = (("local", "local"), ("global_conditioned", "global_cond"), ("global", "global"),
         ("constant", "constant"))
LOG2PI = math.log(2.0 * math.pi)
EPS = 1e-12


@dataclass
class Site:
    name: str
    tier: str
    kind: str  # "Normal", "LogNormal" or "Constant"
    mu: float
    prec: float
    cond_devices: bool = False
    cond_treatments: bool = False


def _site(name, spec, tier, cond):
    kind = spec["distribution"]
    if kind not in ("Normal", "LogNormal"):
        raise ValueError("reference: distribution %r of %s is not supported" % (kind, name))
    if "prec" in spec:
        prec = float(spec["prec"])
    elif "sigma" in spec:
        prec = 1.0 / float(spec["sigma"]) ** 2
    else:
        prec = 1.0
    return Site(name, tier, kind, float(spec.get("mu", 0.0)), prec,
                bool(cond.get("devices", False)), bool(cond.get("treatments", False)))


def parse_sites(params):
    """The sites of a spec's ``params`` dict, in theta order."""
    shared = params.get("shared") or {}
    sites = []
    for key, tier in TIERS:
        block = params.get(key) or {}
        cond = block.get("conditioning") or {}
        for name, spec in block.items():
            if name == "conditioning":
                continue
            if key == "constant":
                sites.append(Site(name, tier, "Constant", float(spec), 1.0))
                continue
            if "distribution" not in spec:
                continue
            if spec["distribution"] in shared:
                spec = shared[spec["distribution"]]
            sites.append(_site(name, spec, tier, cond))
    return sites


class Program:
    """Sampling, clipping and log densities over theta[B, K, n] for a list
    of sites, in the dtype and on the device asked for."""

    def __init__(self, sites, dtype, device):
        self.sites = sites
        self.names = [s.name for s in sites]
        self.n = len(sites)

        def col(values, dt=dtype):
            return torch.tensor(values, dtype=dt, device=device)

        self.is_ln = col([s.kind == "LogNormal" for s in sites], torch.bool)
        self.is_const = col([s.kind == "Constant" for s in sites], torch.bool)
        self.prior_mu = col([s.mu for s in sites])
        self.prior_prec = col([s.prec for s in sites])
        sigma = 1.0 / torch.sqrt(torch.clamp(self.prior_prec, min=EPS))
        lo, hi = self.prior_mu - 4.0 * sigma, self.prior_mu + 4.0 * sigma
        lo = torch.where(self.is_ln, torch.exp(lo), lo)
        hi = torch.where(self.is_ln, torch.exp(hi), hi)
        inf = torch.full_like(lo, math.inf)
        self.clip_lo = torch.where(self.is_const, -inf, lo)
        self.clip_hi = torch.where(self.is_const, inf, hi)

    def tier(self, tier):
        return [s for s in self.sites if s.tier == tier]

    def sample(self, mu, prec, u):
        """theta[B, K, n] from q's mu, prec [B, n] and standard normals u."""
        sigma = 1.0 / torch.sqrt(torch.clamp(prec, min=EPS))
        pre = mu[:, None, :] + sigma[:, None, :] * u
        theta = torch.where(self.is_ln, torch.exp(pre), pre)
        return torch.where(self.is_const, self.prior_mu, theta)

    def clip(self, theta):
        return torch.minimum(torch.maximum(theta, self.clip_lo), self.clip_hi)

    def log_prob(self, mu, prec, theta):
        """sum over sites of log N(theta; mu, 1 / prec) (LogNormal in log
        space with its Jacobian), constants 0: [B, K]."""
        mu, prec = mu[:, None, :], prec[:, None, :]
        x = torch.where(self.is_ln, torch.log(theta + EPS), theta)
        lp = -LOG2PI + 0.5 * torch.log(prec + EPS) - 0.5 * prec * (mu - x) ** 2
        lp = torch.where(self.is_ln, lp - torch.log(theta + EPS), lp)
        return torch.where(self.is_const, torch.zeros_like(lp), lp).sum(-1)

    def log_prior(self, theta):
        return self.log_prob(self.prior_mu[None, :], self.prior_prec[None, :], theta)

    def columns(self, theta):
        """theta[..., n] as named columns."""
        return {name: theta[..., i] for i, name in enumerate(self.names)}
