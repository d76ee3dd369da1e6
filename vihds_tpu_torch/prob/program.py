"""The compiled parameter program: vectorised sample / log_prob / clip on
``theta[B, K, n_theta]`` tensors.

The same static per-site masks as ``vihds_tpu.prob.program`` (built once
from the spec as numpy arrays), applied with ``torch.where``.  ``ndtri`` is
``torch.special.ndtri`` and the standard-normal cdf ``torch.special.ndtr``.
"""

import numpy as np
import torch

from vihds_tpu_torch.prob import sites as S
from vihds_tpu_torch.utils.attrdict import AttrDict

LOG2PI = float(np.log(2.0 * np.pi))
EPS = 1e-12


def _toposort(ordered_sites):
    """Dependency-respecting site order, resolved once at build time."""
    name_to_idx = {s.name: i for i, s in enumerate(ordered_sites)}
    placed = {}
    order = []
    while len(order) < len(ordered_sites):
        progressed = False
        for i, s in enumerate(ordered_sites):
            if i in placed:
                continue
            deps = [d for d in (s.mu_dep, s.prec_dep) if d is not None]
            if all(name_to_idx[d] in placed for d in deps):
                placed[i] = True
                order.append(i)
                progressed = True
        if not progressed:
            raise ValueError("Cyclic dependency among parameter sites")
    return order


def _atleast_2d(x):
    return x if x.dim() >= 2 else x.reshape(1, -1)


class ParamProgram:
    """Static compilation of a ParamSites spec.

    All members are host numpy constants; the methods are functions of
    (q-tensors, u, theta) on whatever device those tensors live on.
    """

    def __init__(self, param_sites: S.ParamSites):
        self.sites = param_sites
        ordered = param_sites.ordered
        self.names = [s.name for s in ordered]
        self.index = {n: i for i, n in enumerate(self.names)}
        self.n_theta = len(ordered)

        kinds = [s.kind for s in ordered]
        self.is_lognormal = np.array([k == S.LOGNORMAL for k in kinds])
        self.is_constant = np.array([k == S.CONSTANT for k in kinds])
        self.is_truncated = np.array([k == S.TRUNCATED for k in kinds])
        self.is_kumaraswamy = np.array([k == S.KUMARASWAMY for k in kinds])
        self.is_normal_family = ~(self.is_constant | self.is_kumaraswamy)

        self.prior_mu = np.array([s.init_mu for s in ordered], np.float32)
        self.prior_prec = np.array([s.init_prec for s in ordered], np.float32)
        self.const_value = np.where(self.is_constant, self.prior_mu, 0.0).astype(np.float32)
        self.trunc_a = np.array([s.a for s in ordered], np.float32)
        self.trunc_b = np.array([s.b for s in ordered], np.float32)
        # Finite stand-ins for the truncation bounds of every column: the
        # masked truncnorm branch is evaluated for all columns, and +-inf
        # bounds would make inf intermediates there.
        self._trunc_a_safe = np.where(
            self.is_truncated, np.nan_to_num(self.trunc_a, neginf=-1e6, posinf=1e6), -1.0
        ).astype(np.float32)
        self._trunc_b_safe = np.where(
            self.is_truncated, np.nan_to_num(self.trunc_b, neginf=-1e6, posinf=1e6), 1.0
        ).astype(np.float32)
        self.zmin = np.array([s.zmin for s in ordered], np.float32)
        self.zmax = np.array([s.zmax for s in ordered], np.float32)

        # Tier index ranges in theta order: local | global_cond | global | const
        edges = np.cumsum([0] + list(param_sites.counts()))
        self.local_slice = slice(edges[0], edges[1])
        self.global_cond_slice = slice(edges[1], edges[2])
        self.global_slice = slice(edges[2], edges[3])
        self.constant_slice = slice(edges[3], edges[4])

        self.dep_sites = []  # (idx, mu_dep_idx | -1, prec_dep_idx | -1)
        for i, s in enumerate(ordered):
            if s.mu_dep is not None or s.prec_dep is not None:
                mu_j = self.index[s.mu_dep] if s.mu_dep is not None else -1
                prec_j = self.index[s.prec_dep] if s.prec_dep is not None else -1
                self.dep_sites.append((i, mu_j, prec_j))
        self.topo_order = _toposort(ordered)
        self.has_deps = len(self.dep_sites) > 0

        self._clip_cache = {}
        self._tensors = {}

    # ------------------------------------------------------------------ helpers
    def _t(self, name, like):
        """The host constant ``name`` as a tensor on ``like``'s device (cached
        per device, so a serving loop uploads each mask once)."""
        key = (name, like.device)
        t = self._tensors.get(key)
        if t is None:
            t = torch.as_tensor(getattr(self, name), device=like.device)
            self._tensors[key] = t
        return t

    def fingerprint(self):
        """SHA1 of the whole program: ``structural_fingerprint`` and the
        prior moments.  The JAX package's digest of the same spec, letter for
        letter (the arrays have its dtypes and the sites its ``repr``s)."""
        import hashlib

        h = hashlib.sha1()
        h.update(self.structural_fingerprint().encode())
        for arr in (self.prior_mu, self.prior_prec):
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()

    def runtime_priors(self, stddevs=4):
        """The prior moments and theta's clip bounds as host float32 arrays
        (``mu``, ``prec``, ``clip_lo``, ``clip_hi``): what differs between
        two programs of one structure, e.g. inference-graph nodes after
        posterior-to-prior propagation."""
        lo, hi = self.clip_bounds(stddevs)
        return AttrDict(
            mu=np.asarray(self.prior_mu, np.float32),
            prec=np.asarray(self.prior_prec, np.float32),
            clip_lo=np.asarray(lo, np.float32),
            clip_hi=np.asarray(hi, np.float32),
        )

    def structural_fingerprint(self):
        """``fingerprint`` without the prior moments: site names, tiers,
        kinds, conditioning, dependency wiring, constant values, truncation
        bounds and Kumaraswamy supports."""
        import hashlib

        h = hashlib.sha1()
        for s in self.sites.ordered:
            h.update(repr((s.name, s.tier, s.kind, s.mu_dep, s.prec_dep, s.cond_devices,
                           s.cond_treatments)).encode())
        for arr in (self.is_lognormal, self.is_constant, self.is_truncated, self.is_kumaraswamy,
                    self.const_value, self.trunc_a, self.trunc_b, self.zmin, self.zmax):
            h.update(np.ascontiguousarray(arr).tobytes())
        h.update(repr(self.dep_sites).encode())
        h.update(repr(self.topo_order).encode())
        h.update(repr((self.local_slice, self.global_cond_slice, self.global_slice,
                       self.constant_slice)).encode())
        return h.hexdigest()

    def prior_q(self, device="cpu"):
        """The prior p as q-style tensors (row-broadcastable)."""
        return AttrDict(
            mu=torch.as_tensor(self.prior_mu, device=device)[None, :],
            prec=torch.as_tensor(self.prior_prec, device=device)[None, :],
        )

    def theta_dict(self, theta):
        """View theta[..., n_theta] as named [...]-column slices."""
        return AttrDict((name, theta[..., i]) for i, name in enumerate(self.names))

    # ------------------------------------------------------------------ sample
    def _transform(self, pre, u, mu_b, prec_b, sigma_b):
        """Map pre-samples (mu + sigma*u) through each site's bijection."""
        theta = pre
        ndtr = torch.special.ndtr
        if self.is_lognormal.any():
            theta = torch.where(self._t("is_lognormal", pre), torch.exp(pre), theta)
        if self.is_truncated.any():
            # inverse-cdf sampling of the truncated normal from u
            is_tr = self._t("is_truncated", pre)
            sigma_safe = torch.where(is_tr, sigma_b, torch.ones_like(sigma_b))
            A = (self._t("_trunc_a_safe", pre) - mu_b) / sigma_safe
            B = (self._t("_trunc_b_safe", pre) - mu_b) / sigma_safe
            PhiA, PhiB = ndtr(A), ndtr(B)
            vv = torch.clamp(PhiA + ndtr(u) * (PhiB - PhiA), 1e-6, 1.0 - 1e-6)
            theta = torch.where(is_tr, mu_b + sigma_b * torch.special.ndtri(vv), theta)
        if self.is_kumaraswamy.any():
            # (mu, prec) slots carry (a, b): x = zmin + zr*(1-(1-v)^(1/b))^(1/a)
            is_k = self._t("is_kumaraswamy", pre)
            v = torch.clamp(ndtr(u), 1e-6, 1.0 - 1e-6)
            a_k = torch.where(is_k, mu_b, torch.ones_like(mu_b))
            b_k = torch.where(is_k, prec_b, torch.ones_like(prec_b))
            zmin, zmax = self._t("zmin", pre), self._t("zmax", pre)
            x = zmin + (zmax - zmin) * (1.0 - (1.0 - v) ** (1.0 / b_k)) ** (1.0 / a_k)
            theta = torch.where(is_k, x, theta)
        if self.is_constant.any():
            theta = torch.where(self._t("is_constant", pre), self._t("const_value", pre), theta)
        return theta

    def sample(self, q, u):
        """Reparameterised draw theta[B,K,n] from standard-normal u[B,K,n]."""
        mu = _atleast_2d(q["mu"])  # [B|1, n]
        prec = _atleast_2d(q["prec"])
        sigma = 1.0 / torch.sqrt(torch.clamp(prec, min=EPS))
        mu_b = mu[:, None, :]
        prec_b = prec[:, None, :]
        sigma_b = sigma[:, None, :]
        pre = mu_b + sigma_b * u
        theta = self._transform(pre, u, mu_b, prec_b, sigma_b)

        if self.has_deps:
            # re-draw dependent sites in topological order, their mu/prec read
            # from already-sampled columns, through the site's own bijection
            ndtr = torch.special.ndtr
            dep_map = {i: (mj, pj) for i, mj, pj in self.dep_sites}
            theta = theta.clone()
            for i in self.topo_order:
                if i not in dep_map:
                    continue
                mj, pj = dep_map[i]
                mu_i = theta[:, :, mj] if mj >= 0 else mu_b[:, :, i]
                prec_i = theta[:, :, pj] if pj >= 0 else torch.clamp(prec, min=EPS)[:, None, i]
                sigma_i = 1.0 / torch.sqrt(torch.clamp(prec_i, min=EPS))
                u_i = u[:, :, i]
                if self.is_kumaraswamy[i]:
                    v = torch.clamp(ndtr(u_i), 1e-6, 1.0 - 1e-6)
                    val = float(self.zmin[i]) + float(self.zmax[i] - self.zmin[i]) * (
                        1.0 - (1.0 - v) ** (1.0 / prec_i)
                    ) ** (1.0 / mu_i)
                elif self.is_truncated[i]:
                    A = (float(self._trunc_a_safe[i]) - mu_i) / sigma_i
                    B = (float(self._trunc_b_safe[i]) - mu_i) / sigma_i
                    PhiA, PhiB = ndtr(A), ndtr(B)
                    vv = torch.clamp(PhiA + ndtr(u_i) * (PhiB - PhiA), 1e-6, 1.0 - 1e-6)
                    val = mu_i + sigma_i * torch.special.ndtri(vv)
                else:
                    pre_i = mu_i + sigma_i * u_i
                    val = torch.exp(pre_i) if self.is_lognormal[i] else pre_i
                theta[:, :, i] = torch.broadcast_to(val, theta[:, :, i].shape)
        return theta

    # ----------------------------------------------------------------- log_prob
    def log_prob(self, q, theta, total=True):
        """Joint log q(theta) over sites, summed to [B,K] (or per-site [B,K,n]).

        Keeps the JAX package's (and its reference's) ``-log(2*pi)`` constant
        instead of the canonical ``-0.5*log(2*pi)``: it cancels between
        log p(theta) and log q(theta) in the IWAE bound, and keeping it keeps
        per-component diagnostics comparable across the packages.
        """
        mu = _atleast_2d(q["mu"])[:, None, :]
        prec = _atleast_2d(q["prec"])[:, None, :]

        if self.has_deps:
            B, K, n = theta.shape
            mu = mu.expand(B, K, n).clone()
            prec = prec.expand(B, K, n).clone()
            for i, mj, pj in self.dep_sites:
                if mj >= 0:
                    mu[:, :, i] = theta[:, :, mj]
                if pj >= 0:
                    prec[:, :, i] = theta[:, :, pj]

        is_ln = self._t("is_lognormal", theta)
        x_eff = torch.where(is_ln, torch.log(theta + EPS), theta)
        lp = -LOG2PI + 0.5 * torch.log(prec + EPS) - 0.5 * prec * (mu - x_eff) ** 2
        lp = torch.where(is_ln, lp - torch.log(theta + EPS), lp)
        if self.is_truncated.any():
            ndtr = torch.special.ndtr
            sigma = 1.0 / torch.sqrt(torch.clamp(prec, min=EPS))
            A = (self._t("_trunc_a_safe", theta) - mu) / sigma
            B_ = (self._t("_trunc_b_safe", theta) - mu) / sigma
            logZ = torch.log(torch.clamp(ndtr(B_) - ndtr(A), min=EPS))
            lp = torch.where(self._t("is_truncated", theta), lp - logZ, lp)
        if self.is_kumaraswamy.any():
            is_k = self._t("is_kumaraswamy", theta)
            a_k = torch.where(is_k, mu, torch.ones_like(mu))
            b_k = torch.where(is_k, prec, torch.ones_like(prec))
            zmin = self._t("zmin", theta)
            zr = self._t("zmax", theta) - zmin
            z = torch.clamp((theta - zmin) / zr, 1e-6, 1.0 - 1e-6)
            lp_k = (
                torch.log(a_k)
                + torch.log(b_k)
                + (a_k - 1.0) * torch.log(z)
                + (b_k - 1.0) * torch.log1p(-(z ** a_k))
                - torch.log(zr)
            )
            lp = torch.where(is_k, lp_k, lp)
        lp = torch.where(self._t("is_constant", theta), torch.zeros_like(lp), lp)
        return lp.sum(-1) if total else lp

    # --------------------------------------------------------------------- clip
    def clip_bounds(self, stddevs=4):
        """Static per-site clip bounds from the PRIOR, as host arrays."""
        key = int(stddevs)
        if key not in self._clip_cache:
            sigma = 1.0 / np.sqrt(np.maximum(self.prior_prec, EPS))
            lo = self.prior_mu - stddevs * sigma
            hi = self.prior_mu + stddevs * sigma
            lo = np.where(self.is_lognormal, np.exp(lo), lo)
            hi = np.where(self.is_lognormal, np.exp(hi), hi)
            # constants and Kumaraswamy sites are not clipped
            no_clip = self.is_constant | self.is_kumaraswamy
            lo = np.where(no_clip, -np.inf, lo).astype(np.float32)
            hi = np.where(no_clip, np.inf, hi).astype(np.float32)
            self._clip_cache[key] = (lo, hi)
        return self._clip_cache[key]

    def clip(self, theta, stddevs=4):
        # the bounds uploaded once per device: a copy from the host each call
        # would wait for the device's queue (a sampler clips every evaluation)
        key = ("clip", int(stddevs), theta.device)
        if key not in self._tensors:
            self._tensors[key] = tuple(torch.as_tensor(b, device=theta.device)
                                       for b in self.clip_bounds(stddevs))
        lo, hi = self._tensors[key]
        return torch.minimum(torch.maximum(theta, lo), hi)
