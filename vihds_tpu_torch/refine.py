"""Posterior refinement beyond amortised VI (the port of ``vihds_tpu.refine``):
HMC over the latent parameters, its pooled, Gibbs and pseudo-marginal forms
over the whole hierarchy, and an SMC sampler that anneals from the amortised
q to the true posterior.

Every sampler:

  * works per datapoint, vectorised over [B (series), K (chains or
    particles)];
  * moves in the UNCONSTRAINED space z (LogNormal sites sample log theta,
    the bounded families move through support bijections with exact
    log-Jacobians), so the prior is exactly Normal(prior_mu, prior_prec) on
    the normal-family sites;
  * reuses the decoder (condition -> integrate -> observe -> log-lik) as the
    likelihood, so any registered model works.  Under a spec's ``solver:
    pallas_<method>`` each evaluation of the likelihood launches the fused
    forward kernel of the model's kind (``dr_fwd``, ``dr_prec_fwd``, ...),
    and each gradient its backward.

Gradients are ``torch.autograd.grad`` of the summed target in z alone: the
model's parameters are held fixed, detached from any graph.  ``make_log_lik``
is looked up through this module when a sampler is called, so a test can
replace it.

Random draws.  A sampler takes ``key``: an integer seed, or a source of
draws with the methods ``normal(name, shape, *index)``,
``uniform(name, shape, *index)`` and ``gumbel(name, shape, *index)``.  An
integer seeds ``Draws``, one ``torch.Generator`` on the sampler's device,
which ignores the names and draws in call order.  The names say which draw
is meant, so that another source can replay another random stream (the
tests replay the JAX package's key schedule):

  ``init``                      z ~ q's standard normals [L, K, n_theta]
  ``momentum`` (t)              HMC momenta (``hmc_refine``, Gibbs locals)
  ``momentum.g|c|l`` (t)        pooled HMC momenta, one per state leaf
  ``accept`` (t)                Metropolis uniforms
  ``accept_local`` / ``accept_shared`` (t)   the Gibbs blocks' uniforms
  ``proposal.g|c`` (t)          random-walk proposals of the shared tier
  ``particles``                 the pseudo-marginal u [L, K, P, n_theta]
  ``refresh`` / ``accept_refresh`` (t)       its Crank-Nicolson u move
  ``pick``                      the Gumbel noise of the final particle pick
  ``resample`` (t)              SMC's systematic-resampling uniforms [B]
  ``momentum`` / ``accept`` (t, m)           SMC's HMC move m at temperature t
"""

import math

import numpy as np
import torch

from vihds_tpu_torch.ops.logprob import log_prob_observations
from vihds_tpu_torch.utils.attrdict import AttrDict

LOG2PI = math.log(2.0 * math.pi)
# bound on |z| inside exp/sigmoid of masked truncation branches: keeps the
# discarded branches' primals finite so torch.where gradients stay NaN-free
_ZCAP = 30.0
_F32 = torch.float32


class Draws:
    """The default source of a sampler's draws: one ``torch.Generator`` on
    ``device`` seeded with ``seed``, drawn in call order (the names and
    indices are ignored)."""

    def __init__(self, seed, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    def normal(self, name, shape, *index):
        return torch.randn(shape, generator=self.generator, device=self.device)

    def uniform(self, name, shape, *index):
        return torch.rand(shape, generator=self.generator, device=self.device)

    def gumbel(self, name, shape, *index):
        u = torch.clamp(self.uniform(name, shape, *index), min=torch.finfo(_F32).tiny)
        return -torch.log(-torch.log(u))


def as_draws(key, device):
    """``key`` as a source of draws: an integer seeds ``Draws`` on ``device``."""
    return key if hasattr(key, "normal") else Draws(key, device)


def _fixed(params):
    """The param tree detached from any graph: the samplers differentiate in
    z alone."""
    if isinstance(params, dict):
        return {k: _fixed(v) for k, v in params.items()}
    return params.detach()


def _grad(f):
    """z -> d f(z).sum() / d z, with z the only leaf that requires grad."""

    def grad(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(f(z).sum(), z)
        return g

    return grad


def _host(arr, like, dtype=_F32):
    """A host array (or a tensor) as a ``dtype`` tensor on ``like``'s device."""
    return torch.as_tensor(arr, dtype=dtype, device=like.device)


def _mask(arr, like):
    return torch.as_tensor(np.asarray(arr, bool), device=like.device)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _median(x):
    """``jnp.median`` of all of ``x``: the mean of the two middle values
    where the count is even (``torch.median`` takes the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _nan_to_neg_inf(x):
    """``jnp.nan_to_num(x, nan=-inf)`` as JAX computes it: NaN becomes -inf,
    then every infinity the largest finite float of its sign, so NaN ends at
    -3.4e38 in float32 (``torch.nan_to_num(x, nan=-inf)`` leaves it -inf)."""
    return torch.nan_to_num(x, nan=torch.finfo(x.dtype).min)


def _sampled_mask(program, like):
    """Which theta columns the samplers move: every non-constant site
    (bounded families move through the support bijections below).
    Dependent-site (a, b)/(mu, prec) wiring is held at the PRIOR values —
    the same static-prior convention the whole module uses."""
    return _host((~program.is_constant).astype(np.float32), like)


def _trunc_cases(program):
    """(two_sided, lower_only, upper_only) boolean masks over theta columns."""
    lo = np.isfinite(program.trunc_a) & program.is_truncated
    hi = np.isfinite(program.trunc_b) & program.is_truncated
    return lo & hi, lo & ~hi, hi & ~lo


def _constrain_truncated(program, z):
    """z -> theta on the truncation support (garbage on other columns):
    two-sided a + (b-a)*sigmoid(z); one-sided a + e^z / b - e^z."""
    _, lo, hi = _trunc_cases(program)
    a, b = program._t("_trunc_a_safe", z), program._t("_trunc_b_safe", z)
    zc = torch.clamp(z, -_ZCAP, _ZCAP)
    th = a + (b - a) * torch.sigmoid(zc)
    th = torch.where(_mask(lo, z), a + torch.exp(zc), th)
    th = torch.where(_mask(hi, z), b - torch.exp(zc), th)
    return th


def _log_jac_truncated(program, z):
    """log |d theta / d z| of _constrain_truncated (garbage elsewhere)."""
    two, _, _ = _trunc_cases(program)
    a, b = program._t("_trunc_a_safe", z), program._t("_trunc_b_safe", z)
    zc = torch.clamp(z, -_ZCAP, _ZCAP)
    # log(b-a) + log sigmoid(z) + log sigmoid(-z); one-sided: z
    lj = torch.log(torch.clamp(b - a, min=1e-12)) - _softplus(-zc) - _softplus(zc)
    return torch.where(_mask(two, z), lj, zc)


def _constrain_kuma(program, z):
    """z -> theta on the Kumaraswamy support [zmin, zmax] (garbage on other
    columns): zmin + (zmax - zmin) * sigmoid(z)."""
    zc = torch.clamp(z, -_ZCAP, _ZCAP)
    zmin, zmax = program._t("zmin", z), program._t("zmax", z)
    return zmin + (zmax - zmin) * torch.sigmoid(zc)


def _log_jac_kuma(program, z):
    zc = torch.clamp(z, -_ZCAP, _ZCAP)
    zr = torch.clamp(program._t("zmax", z) - program._t("zmin", z), min=1e-12)
    return torch.log(zr) - _softplus(-zc) - _softplus(zc)


def _log_kuma_pdf(program, theta, a, b):
    """Kumaraswamy(a, b) log-density at theta on [zmin, zmax] (the (mu,
    prec) slots carry (a, b) — same convention as ParamProgram.log_prob)."""
    zmin = program._t("zmin", theta)
    zr = torch.clamp(program._t("zmax", theta) - zmin, min=1e-12)
    v = torch.clamp((theta - zmin) / zr, 1e-6, 1.0 - 1e-6)
    return (
        torch.log(a) + torch.log(b)
        + (a - 1.0) * torch.log(v)
        + (b - 1.0) * torch.log1p(-(v ** a))
        - torch.log(zr)
    )


def unconstrain_kuma(program, theta):
    zmin = program._t("zmin", theta)
    zr = torch.clamp(program._t("zmax", theta) - zmin, min=1e-12)
    v = torch.clamp((theta - zmin) / zr, 1e-6, 1.0 - 1e-6)
    return torch.log(v) - torch.log1p(-v)


def unconstrain_truncated(program, theta):
    """Inverse of _constrain_truncated on the truncated columns."""
    _, lo, hi = _trunc_cases(program)
    a, b = program._t("_trunc_a_safe", theta), program._t("_trunc_b_safe", theta)
    eps = 1e-6
    ta = torch.clamp(theta - a, min=eps)
    bt = torch.clamp(b - theta, min=eps)
    z = torch.log(ta) - torch.log(bt)  # logit((theta-a)/(b-a)) up to the (b-a) scale
    z = torch.where(_mask(lo, theta), torch.log(ta), z)
    z = torch.where(_mask(hi, theta), torch.log(bt), z)
    return z


def constrain_z(program, z):
    """Unconstrained z -> constrained theta (exp for LogNormal, bounded
    bijection for TruncatedNormal / Kumaraswamy, fixed for constants)."""
    theta = torch.where(program._t("is_lognormal", z), torch.exp(z), z)
    if program.is_truncated.any():
        theta = torch.where(program._t("is_truncated", z), _constrain_truncated(program, z), theta)
    if program.is_kumaraswamy.any():
        theta = torch.where(program._t("is_kumaraswamy", z), _constrain_kuma(program, z), theta)
    return torch.where(program._t("is_constant", z), program._t("const_value", z), theta)


def _normal_logpdf(z, mu, prec):
    return -0.5 * LOG2PI + 0.5 * torch.log(prec) - 0.5 * prec * (z - mu) ** 2


def log_prior_z_cols(program, z, idx=None):
    """Per-site prior log-density IN z-SPACE, [..., n_idx] over theta
    columns ``idx`` (default: all).

    Normal/LogNormal sites: exactly N(z; prior_mu, prior_prec) (the
    LogNormal Jacobian cancels — z IS log theta there).  TruncatedNormal
    sites: TN(theta(z); prior, a, b) + log|d theta/d z| so that HMC in z
    targets exactly the truncated prior; Kumaraswamy likewise."""
    idx = np.arange(program.n_theta) if idx is None else np.asarray(idx)
    prior_mu, prior_prec = program._t("prior_mu", z), program._t("prior_prec", z)
    # the samplers' columns are a tier's contiguous slice: index with it, no
    # host-to-device copy (which would wait for the device's queue)
    contiguous = len(idx) > 0 and bool((np.diff(idx) == 1).all())
    idx_t = (slice(int(idx[0]), int(idx[-1]) + 1) if contiguous
             else torch.as_tensor(idx, dtype=torch.int64, device=z.device))
    lp = _normal_logpdf(z, prior_mu[idx_t], prior_prec[idx_t])
    if not (program.is_truncated[idx].any() or program.is_kumaraswamy[idx].any()):
        return lp
    # full-width bounded-family machinery, then select the idx columns
    idx_full = torch.as_tensor(idx, dtype=torch.int64, device=z.device)
    zf = z.new_zeros(z.shape[:-1] + (program.n_theta,)).index_copy(-1, idx_full, z)
    if program.is_truncated[idx].any():
        theta = _constrain_truncated(program, zf)
        sigma = 1.0 / torch.sqrt(prior_prec)
        A = (program._t("_trunc_a_safe", z) - prior_mu) / sigma
        B = (program._t("_trunc_b_safe", z) - prior_mu) / sigma
        logZ = torch.log(torch.clamp(torch.special.ndtr(B) - torch.special.ndtr(A), min=1e-12))
        lp_t = (
            _normal_logpdf(theta, prior_mu, prior_prec) - logZ + _log_jac_truncated(program, zf)
        )[..., idx_t]
        lp = torch.where(_mask(program.is_truncated[idx], z), lp_t, lp)
    if program.is_kumaraswamy[idx].any():
        # (mu, prec) slots carry (a, b); guard the discarded columns with 1s
        is_k = program._t("is_kumaraswamy", z)
        a_k = torch.where(is_k, prior_mu, torch.ones_like(prior_mu))
        b_k = torch.where(is_k, prior_prec, torch.ones_like(prior_prec))
        lp_k = (
            _log_kuma_pdf(program, _constrain_kuma(program, zf), a_k, b_k)
            + _log_jac_kuma(program, zf)
        )[..., idx_t]
        lp = torch.where(_mask(program.is_kumaraswamy[idx], z), lp_k, lp)
    return lp


def make_log_lik(model, program, params, batch):
    """log p(x_b | theta_bk) as a function of theta[B,K,n]."""
    n_times = batch.times.shape[0]

    def log_lik(theta):
        th = program.theta_dict(program.clip(theta, stddevs=4))
        if model.condition_on_device:
            th = model.ode_model.condition_theta(params["dec"], th, batch.dev_1hot)
        sol = model.ode_model.simulate(
            params["dec"], th, batch.times, batch.inputs, batch.dev_1hot, n_iwae=theta.shape[1]
        )
        x_states, precisions = model.ode_model.expand_precisions(params["dec"], th, n_times, sol)
        x_predict = model.ode_model.observe(x_states, th)
        lp = log_prob_observations(x_predict, batch.observations, precisions, model.use_laplace)
        return lp.sum(dim=2)  # [B, K]

    return log_lik


def make_log_joint(model, program, params, batch, site_mask=None):
    """log p(x, z) = log p(x | T(z)) + N(z; prior) summed over sampled sites.

    ``site_mask`` restricts which theta columns contribute the prior term
    (defaults to every non-constant site); pass e.g. a local-sites-only
    mask for cut inference where the frozen sites' values ride in z but are
    not part of the target."""
    log_lik = make_log_lik(model, program, params, batch)
    like = batch.observations
    mask = _sampled_mask(program, like) if site_mask is None else _host(site_mask, like)

    def log_joint(z):
        lp_prior = (log_prior_z_cols(program, z) * mask).sum(-1)
        return log_lik(constrain_z(program, z)) + lp_prior

    return log_joint


def z_from_u(program, u, mu_b, prec_b):
    """Map standard normals u [..., n_theta] through q's reparameterisation
    to unconstrained z (q's mu/prec parameterise z directly for
    Normal/LogNormal sites; TruncatedNormal sites draw theta by inverse CDF
    — exactly program.sample's rule — and map through the bijection;
    Kumaraswamy via its inverse CDF).  mu_b/prec_b broadcast against u."""
    sigma_b = 1.0 / torch.sqrt(torch.clamp(prec_b, min=1e-12))
    z = mu_b + sigma_b * u
    if program.is_truncated.any():
        is_tr = program._t("is_truncated", u)
        sig_safe = torch.where(is_tr, sigma_b, torch.ones_like(sigma_b))
        A = (program._t("_trunc_a_safe", u) - mu_b) / sig_safe
        B = (program._t("_trunc_b_safe", u) - mu_b) / sig_safe
        PhiA, PhiB = torch.special.ndtr(A), torch.special.ndtr(B)
        vv = torch.clamp(PhiA + torch.special.ndtr(u) * (PhiB - PhiA), 1e-6, 1.0 - 1e-6)
        theta_t = mu_b + sig_safe * torch.special.ndtri(vv)
        z = torch.where(is_tr, unconstrain_truncated(program, theta_t), z)
    if program.is_kumaraswamy.any():
        # program.sample's rule: x = zmin + zr*(1-(1-v)^(1/b))^(1/a), v=Phi(u)
        is_k = program._t("is_kumaraswamy", u)
        v = torch.clamp(torch.special.ndtr(u), 1e-6, 1.0 - 1e-6)
        a_k = torch.where(is_k, mu_b, torch.ones_like(mu_b))
        b_k = torch.where(is_k, prec_b, torch.ones_like(prec_b))
        zmin, zmax = program._t("zmin", u), program._t("zmax", u)
        x = zmin + (zmax - zmin) * (1.0 - (1.0 - v) ** (1.0 / b_k)) ** (1.0 / a_k)
        z = torch.where(is_k, unconstrain_kuma(program, x), z)
    return z


def init_z_from_q(model, program, params, batch, key, n_samples):
    """Draw z ~ q in unconstrained space (see ``z_from_u`` for the
    per-family reparameterisation rules); ``key`` a seed or a source of
    draws (its ``init`` draw).  Unsharded: one device holds every chain."""
    draws = as_draws(key, batch.observations.device)
    q = model.encoder(params["enc"], batch)
    u = draws.normal("init", (q.mu.shape[0], n_samples, program.n_theta))
    mu_b, prec_b = q.mu[:, None, :], q.prec[:, None, :]
    z = z_from_u(program, u, mu_b, prec_b)
    log_q = (log_q_z_sites(program, z, mu_b, prec_b) * _sampled_mask(program, z)).sum(-1)
    return z, log_q, q


def log_q_z_sites(program, z, mu_b, prec_b):
    """Per-site log q IN z-SPACE: plain Normal for Normal/LogNormal sites
    (q parameterises z directly); for TruncatedNormal sites q parameterises
    theta-space, so TN(theta(z); q, a, b) + log|d theta/d z|; for
    Kumaraswamy sites the (mu, prec) slots carry q's (a, b)."""
    lq = _normal_logpdf(z, mu_b, prec_b)
    if program.is_truncated.any():
        is_tr = program._t("is_truncated", z)
        sigma_b = 1.0 / torch.sqrt(torch.clamp(prec_b, min=1e-12))
        sig_safe = torch.where(is_tr, sigma_b, torch.ones_like(sigma_b))
        A = (program._t("_trunc_a_safe", z) - mu_b) / sig_safe
        B = (program._t("_trunc_b_safe", z) - mu_b) / sig_safe
        logZ = torch.log(torch.clamp(torch.special.ndtr(B) - torch.special.ndtr(A), min=1e-12))
        lq_t = (
            _normal_logpdf(_constrain_truncated(program, z), mu_b, prec_b)
            - logZ
            + _log_jac_truncated(program, z)
        )
        lq = torch.where(is_tr, lq_t, lq)
    if program.is_kumaraswamy.any():
        is_k = program._t("is_kumaraswamy", z)
        a_k = torch.where(is_k, mu_b, torch.ones_like(mu_b))
        b_k = torch.where(is_k, prec_b, torch.ones_like(prec_b))
        lq_k = (
            _log_kuma_pdf(program, _constrain_kuma(program, z), a_k, b_k)
            + _log_jac_kuma(program, z)
        )
        lq = torch.where(is_k, lq_k, lq)
    return lq


def _log_scalar(x, like):
    """log of a Python float, taken in float32 as the JAX package takes it."""
    return torch.log(torch.tensor(float(x), dtype=_F32, device=like.device))


def _accept(draws, name, log_alpha, *index):
    """Metropolis decisions: log u < log_alpha, one uniform ``name`` each."""
    return torch.log(draws.uniform(name, tuple(log_alpha.shape), *index)) < log_alpha


def _window_mass(z_window, mask):
    """``adapt_mass``'s kinetic mass [B, 1, n]: the inverse of each (series,
    coordinate)'s variance over the window's steps and chains
    (``z_window`` [w, B, K, n]; the population variance, as ``jnp.var``),
    1 on the unmoved columns."""
    var = torch.clamp(z_window.var(dim=(0, 2), correction=0), min=1e-10)  # [B, n]
    return torch.where(mask > 0, 1.0 / var, torch.ones_like(var))[:, None, :]


def _adapt_step(accept, alpha, log_eps, n_accept, t, n_warmup, target):
    """The HMC samplers' Robbins-Monro adaptation of the log step sizes
    toward ``target`` during warmup (absolute steps t < n_warmup), and the
    post-warmup accept count."""
    adapt = float(t < n_warmup)
    counted = float(t >= n_warmup)
    return (log_eps + adapt * 0.3 * (alpha - target),
            n_accept + counted * accept.to(_F32))


# --------------------------------------------------------------------------- #
# HMC
# --------------------------------------------------------------------------- #
def hmc_refine(
    model,
    program,
    params,
    batch,
    key,
    n_chains=32,
    n_steps=50,
    n_leapfrog=5,
    step_scale=0.05,
    target_accept=0.7,
    site_mask=None,
    return_trace=False,
    init_inflate=1.0,
    mass_from_q=False,
    adapt_mass=False,
):
    """HMC over z, one chain per (datapoint, sample) pair, initialised at q.

    The mass matrix is the diagonal prior precision, so the per-site step is
    automatically scaled by the prior sigma; ``step_scale`` seeds a per-chain
    step size that is Robbins-Monro-adapted toward ``target_accept`` during
    the first half of the run.  Returns refined theta samples and diagnostics
    (including ``z_init``, the amortised starting draw).

    ``mass_from_q=True`` preconditions the kinetic mass with each SERIES'
    amortised q precision instead of the prior's (only Normal/LogNormal
    columns use q: bounded-family q parameterises theta-space, not z).
    ``init_inflate`` overdisperses the start about q's mean on those
    columns.  ``adapt_mass`` runs the first half of warmup under the seed
    mass, then the rest under the inverse of the chains' ensemble variance
    over the last window of that half.

    ``site_mask`` ([n_theta] float, optional) restricts which sites the
    sampler MOVES; unmasked sites keep their per-chain amortised-q draw
    (with a local-sites-only mask this is cut inference).  With
    ``return_trace`` the result holds ``z_trace``, the post-accept z after
    every step [n_steps, B, K, n_theta].

    Evaluations per step: the target at the start, ``n_leapfrog + 1``
    gradients, the target at the proposal; plus one gradient before the
    first step and the target after the last."""
    like = batch.observations
    draws = as_draws(key, like.device)
    params = _fixed(params)
    with torch.no_grad():
        log_joint = make_log_joint(model, program, params, batch, site_mask)
        grad_log_joint = _grad(log_joint)
        mask = _sampled_mask(program, like) if site_mask is None else _host(site_mask, like)
        prior_prec = program._t("prior_prec", like)

        z, _, q = init_z_from_q(model, program, params, batch, draws, n_chains)
        z_param = _host(~(program.is_truncated | program.is_kumaraswamy), like)
        if mass_from_q:
            mass_prec = torch.where(
                z_param > 0, torch.clamp(q.prec, min=1e-12), prior_prec
            )[:, None, :]                                   # [L, 1, n]
        else:
            mass_prec = prior_prec
        if init_inflate != 1.0:
            # overdispersed multi-start about q's mean, on the columns where
            # q.mu parameterises z directly
            z = z + (init_inflate - 1.0) * z_param * (z - q.mu[:, None, :])
        z_init = z
        n_warmup = n_steps // 2

        def run_phase(z, log_eps, n_accept, m_prec, t0, n, trace):
            """``n`` steps from absolute step ``t0`` under the fixed mass
            ``m_prec``; returns the state and the per-step median target
            (and post-accept z where ``trace``)."""
            inv_mass = torch.where(mask > 0, 1.0 / m_prec, torch.zeros_like(m_prec))
            base_step = torch.where(mask > 0, 1.0 / torch.sqrt(m_prec), torch.zeros_like(m_prec))

            def leapfrog(z, p, step):
                g = grad_log_joint(z) * mask
                p = p + 0.5 * step * g
                for _ in range(n_leapfrog - 1):
                    z = z + step * inv_mass * p
                    g = grad_log_joint(z) * mask
                    p = p + step * g
                z = z + step * inv_mass * p
                p = p + 0.5 * step * (grad_log_joint(z) * mask)
                return z, p

            lj_trace, z_trace = [], []
            for t in range(t0, t0 + n):
                step = torch.exp(log_eps)[:, :, None] * base_step  # per-chain step
                p = draws.normal("momentum", tuple(z.shape), t) * torch.sqrt(m_prec) * mask
                lj0 = log_joint(z)
                ke0 = 0.5 * (p ** 2 * inv_mass).sum(-1)
                z_new, p_new = leapfrog(z, p, step)
                lj1 = log_joint(z_new)
                ke1 = 0.5 * (p_new ** 2 * inv_mass).sum(-1)
                log_alpha = _nan_to_neg_inf((lj1 - ke1) - (lj0 - ke0))
                alpha = torch.clamp(torch.exp(log_alpha), max=1.0)
                accept = _accept(draws, "accept", log_alpha, t)
                z = torch.where(accept[:, :, None], z_new, z)
                log_eps, n_accept = _adapt_step(accept, alpha, log_eps, n_accept, t, n_warmup,
                                                target_accept)
                # median across chains: robust to the occasional diverged chain
                lj_trace.append(_median(lj0))
                if trace:
                    z_trace.append(z)
            return (z, log_eps, n_accept, torch.stack(lj_trace),
                    torch.stack(z_trace) if trace else None)

        # Per-chain initial step scaled by the local gradient magnitude: a unit
        # leapfrog displacement should perturb the energy by O(1) even from the
        # crude amortised initialisation, where |grad log p| can be astronomical.
        base_step0 = torch.where(mask > 0, 1.0 / torch.sqrt(mass_prec),
                                 torch.zeros_like(mass_prec))
        g0 = grad_log_joint(z) * mask
        g_scale = torch.sqrt(torch.sum((g0 * base_step0) ** 2, dim=-1))  # [B, K]
        log_eps0 = _log_scalar(step_scale, like) - torch.log1p(g_scale)
        n_accept0 = torch.zeros(z.shape[:2], device=like.device)
        if adapt_mass:
            # windowed mass adaptation: the cross-chain ensemble variance over
            # the last window of the first half of warmup
            n1 = max(n_warmup // 2, 1)
            z, log_eps, n_accept, lj1_trace, z1_trace = run_phase(
                z, log_eps0, n_accept0, mass_prec, 0, n1, True)
            w = max(min(n1 // 2, 200), 1)
            mass2 = _window_mass(z1_trace[-w:], mask)
            z, log_eps, n_accept, lj2_trace, z2_trace = run_phase(
                z, log_eps, n_accept, mass2, n1, n_steps - n1, return_trace)
            lj_trace = torch.cat([lj1_trace, lj2_trace])
            z_trace = torch.cat([z1_trace, z2_trace]) if return_trace else None
        else:
            z, log_eps, n_accept, lj_trace, z_trace = run_phase(
                z, log_eps0, n_accept0, mass_prec, 0, n_steps, return_trace)
        out = AttrDict(
            theta=constrain_z(program, z),
            z=z,
            z_init=z_init,
            accept_rate=n_accept / max(n_steps - n_warmup, 1),
            step_size=torch.exp(log_eps),
            log_joint=log_joint(z),
            log_joint_trace=lj_trace,
            n_warmup=n_warmup,
        )
        if return_trace:
            # post-accept z after every step; the post-warmup slice feeds the
            # ESS / split-R-hat mixing diagnostics (recovery_study)
            out["z_trace"] = z_trace
        return out


# --------------------------------------------------------------------------- #
# The shared tiers of a pooled state
# --------------------------------------------------------------------------- #
class _DeviceRows(torch.autograd.Function):
    """c [D, ...] -> c[dev_idx] [L, ...]: the forward gathers rows; the
    backward sums each device's rows through a one-hot product (a reduction
    in a fixed order, where the backward of an index would accumulate with
    atomics on the card and differ run to run)."""

    @staticmethod
    def forward(ctx, c, dev_idx, onehot):
        ctx.save_for_backward(onehot)
        return c.index_select(0, dev_idx)

    @staticmethod
    def backward(ctx, grad):
        (onehot,) = ctx.saved_tensors                     # [L, D]
        by_device = onehot.t().reshape(onehot.shape[::-1] + (1,) * (grad.dim() - 1))
        return (by_device.to(grad.dtype) * grad[None]).sum(1), None, None


class _Tiers:
    """The pooled samplers' shared structure: device ids densified per batch
    (``devices``: an integer device per series, default one device), each
    device's first series, the tiers' column slices and movable masks."""

    def __init__(self, program, L, devices, like):
        raw_dev = np.zeros(L, np.int32) if devices is None else np.asarray(devices, np.int32)
        # densify device ids (a subset of devices may appear in this batch)
        _, dev_np = np.unique(raw_dev, return_inverse=True)
        self.dev_np = dev_np.astype(np.int32).reshape(-1)
        self.D = int(self.dev_np.max()) + 1
        self.first_row = np.array([np.flatnonzero(self.dev_np == d)[0] for d in range(self.D)])
        self.dev_idx = torch.as_tensor(self.dev_np, dtype=torch.int64, device=like.device)
        self.first_idx = torch.as_tensor(self.first_row, dtype=torch.int64, device=like.device)
        self.onehot = (self.dev_idx[:, None]
                       == torch.arange(self.D, device=like.device)[None, :]).to(_F32)
        self.gsl, self.csl, self.lsl = (program.global_slice, program.global_cond_slice,
                                        program.local_slice)
        self.ksl = program.constant_slice
        if not (self.lsl.start == 0 and self.lsl.stop == self.csl.start
                and self.csl.stop == self.gsl.start and self.gsl.stop == self.ksl.start
                and self.ksl.stop == program.n_theta):
            raise ValueError("theta columns are not ordered local, conditioned, global, constant")
        self.idx_g, self.idx_c, self.idx_l = (np.arange(program.n_theta)[s]
                                              for s in (self.gsl, self.csl, self.lsl))
        # same movable policy as _sampled_mask (bounded families move through
        # the support bijections; only constants stay fixed)
        mov = (~program.is_constant).astype(np.float32)
        self.mg, self.mc, self.ml = (_host(mov[s], like) for s in (self.gsl, self.csl, self.lsl))

    def rows(self, c):
        """c [D, ...] -> [L, ...], each series its device's row."""
        return _DeviceRows.apply(c, self.dev_idx, self.onehot)

    def split(self, z0):
        """(g [K, nG] of series 0, c [D, K, nC] of each device's first series,
        l [L, K, nL]) of z0 [L, K, n]."""
        return (z0[0, :, self.gsl], z0.index_select(0, self.first_idx)[:, :, self.csl],
                z0[:, :, self.lsl])

    def join(self, z0, g_full, c_full, l_full):
        """z [L, K, n] from its tiers, constants from z0."""
        return torch.cat([l_full, c_full, g_full, z0[..., self.ksl]], dim=-1)


# --------------------------------------------------------------------------- #
# Pooled joint HMC
# --------------------------------------------------------------------------- #
def hmc_refine_pooled(
    model,
    program,
    params,
    batch,
    key,
    devices=None,
    n_chains=8,
    n_steps=100,
    n_leapfrog=10,
    step_scale=0.02,
    target_accept=0.7,
    return_trace=False,
    mass_from_q=False,
):
    """Joint HMC over the FULL hierarchy: the exact posterior
    p(shared, locals | all series), pooling evidence across the dataset.

    This sampler carries ONE shared-block state per chain: global sites
    once, global_conditioned sites once per device (``devices``: integer
    device index per series, default a single device), and a local block
    per series, so the K chains sample the true hierarchical joint.

    The state is ``{g: [K, nG], c: [D, K, nC], l: [L, K, nL]}``; momenta,
    diagonal prior-precision masses (``mass_from_q``: the amortised q's)
    and leapfrog updates act leaf-wise, and accept/reject is ONE Metropolis
    decision per chain over the whole state.  Constant sites keep their
    amortised draw; frozen SHARED coordinates are tied to one representative
    draw per scope (z0 row 0 for globals, each device's first row for
    conditioned sites).  Returns full-theta samples [L, K, n_theta] plus
    diagnostics; with ``return_trace`` the post-accept states per step
    (``state_trace``: {g: [S, K, nG], c: [S, D, K, nC], l: [S, L, K, nL]})."""
    like = batch.observations
    draws = as_draws(key, like.device)
    params = _fixed(params)
    with torch.no_grad():
        L = batch.observations.shape[0]
        tiers = _Tiers(program, L, devices, like)
        mg, mc, ml = tiers.mg, tiers.mc, tiers.ml
        prior_mu, prior_prec = program._t("prior_mu", like), program._t("prior_prec", like)
        pg, pc, pl = (prior_prec[s] for s in (tiers.gsl, tiers.csl, tiers.lsl))
        log_lik = make_log_lik(model, program, params, batch)
        z0, _, q0 = init_z_from_q(model, program, params, batch, draws, n_chains)  # [L,K,n]

        def where_on(m, x):
            return torch.where(m > 0, x, torch.zeros_like(x))

        if mass_from_q:
            # Euclidean-metric preconditioning: kinetic mass = the amortised
            # q precision per coordinate, uniform base step; the target stays
            # the exact hierarchical posterior
            qp = torch.clamp(q0.prec, min=1e-8)
            mp = dict(
                g=qp[0, tiers.gsl],                                               # [nG]
                c=qp.index_select(0, tiers.first_idx)[:, tiers.csl][:, None, :],  # [D,1,nC]
                l=qp[:, tiers.lsl][:, None, :],                                   # [L,1,nL]
            )
            masks = dict(g=mg, c=mc, l=ml)
            im = {k: where_on(masks[k], 1.0 / mp[k]) for k in mp}
            bs = {k: where_on(masks[k], torch.ones_like(masks[k])) for k in mp}
            p_scale = {k: where_on(masks[k], torch.sqrt(mp[k])) for k in mp}
        else:
            im = dict(g=where_on(mg, 1.0 / pg), c=where_on(mc, 1.0 / pc), l=where_on(ml, 1.0 / pl))
            bs = dict(g=where_on(mg, 1.0 / torch.sqrt(pg)), c=where_on(mc, 1.0 / torch.sqrt(pc)),
                      l=where_on(ml, 1.0 / torch.sqrt(pl)))
            p_scale = dict(g=torch.sqrt(pg) * mg, c=torch.sqrt(pc) * mc, l=torch.sqrt(pl) * ml)
        g0, c0, l0 = tiers.split(z0)
        state0 = dict(g=g0, c=c0, l=l0)

        # Frozen (non-movable) SHARED coordinates stay shared too: tied to the
        # rows the sampled state was seeded from
        frozen_g = torch.broadcast_to(z0[0:1, :, tiers.gsl], (L,) + tuple(g0.shape))
        frozen_c = c0.index_select(0, tiers.dev_idx)
        frozen_l = z0[:, :, tiers.lsl]

        def assemble(s):
            g_full = torch.where(mg > 0, torch.broadcast_to(s["g"][None], frozen_g.shape),
                                 frozen_g)
            c_full = torch.where(mc > 0, tiers.rows(s["c"]), frozen_c)
            l_full = torch.where(ml > 0, s["l"], frozen_l)
            return tiers.join(z0, g_full, c_full, l_full)

        def log_joint(s):  # [K]: data term pooled over series; each prior counted once
            ll = log_lik(constrain_z(program, assemble(s))).sum(0)
            lp_g = (log_prior_z_cols(program, s["g"], tiers.idx_g) * mg).sum(-1)
            lp_c = (log_prior_z_cols(program, s["c"], tiers.idx_c) * mc).sum(-1).sum(0)
            lp_l = (log_prior_z_cols(program, s["l"], tiers.idx_l) * ml).sum(-1).sum(0)
            return ll + lp_g + lp_c + lp_l

        def grad_lj(s):
            with torch.enable_grad():
                leaves = {k: v.detach().requires_grad_(True) for k, v in s.items()}
                grads = torch.autograd.grad(log_joint(leaves).sum(), list(leaves.values()))
            return dict(zip(leaves, grads))

        def step_tree(log_eps):  # per-chain step broadcast to each leaf's layout
            e = torch.exp(log_eps)
            return dict(g=e[:, None] * bs["g"], c=e[None, :, None] * bs["c"],
                        l=e[None, :, None] * bs["l"])

        def draw_p(t):
            return {k: draws.normal("momentum." + k, tuple(state0[k].shape), t) * p_scale[k]
                    for k in ("g", "c", "l")}

        def kinetic(p):  # [K]
            return 0.5 * (
                (p["g"] ** 2 * im["g"]).sum(-1)
                + (p["c"] ** 2 * im["c"]).sum(-1).sum(0)
                + (p["l"] ** 2 * im["l"]).sum(-1).sum(0)
            )

        def leapfrog(s, p, st):
            g = grad_lj(s)
            p = {k: p[k] + 0.5 * st[k] * g[k] for k in p}
            for _ in range(n_leapfrog - 1):
                s = {k: s[k] + st[k] * im[k] * p[k] for k in s}
                g = grad_lj(s)
                p = {k: p[k] + st[k] * g[k] for k in p}
            s = {k: s[k] + st[k] * im[k] * p[k] for k in s}
            g = grad_lj(s)
            p = {k: p[k] + 0.5 * st[k] * g[k] for k in p}
            return s, p

        def select(accept, new, old):
            return dict(
                g=torch.where(accept[:, None], new["g"], old["g"]),
                c=torch.where(accept[None, :, None], new["c"], old["c"]),
                l=torch.where(accept[None, :, None], new["l"], old["l"]),
            )

        n_warmup = n_steps // 2
        # gradient-scaled initial step, as in hmc_refine, over the pooled state
        g_init = grad_lj(state0)
        st1 = step_tree(torch.zeros(n_chains, device=like.device))
        g_scale = torch.sqrt(
            ((g_init["g"] * st1["g"]) ** 2).sum(-1)
            + ((g_init["c"] * st1["c"]) ** 2).sum(-1).sum(0)
            + ((g_init["l"] * st1["l"]) ** 2).sum(-1).sum(0)
        )
        log_eps = _log_scalar(step_scale, like) - torch.log1p(g_scale)
        s, n_accept = state0, torch.zeros(n_chains, device=like.device)
        lj_trace, s_trace = [], []
        for t in range(n_steps):
            st = step_tree(log_eps)
            p = draw_p(t)
            lj0, ke0 = log_joint(s), kinetic(p)
            s_new, p_new = leapfrog(s, p, st)
            lj1, ke1 = log_joint(s_new), kinetic(p_new)
            log_alpha = _nan_to_neg_inf((lj1 - ke1) - (lj0 - ke0))
            alpha = torch.clamp(torch.exp(log_alpha), max=1.0)
            accept = _accept(draws, "accept", log_alpha, t)
            s = select(accept, s_new, s)
            log_eps, n_accept = _adapt_step(accept, alpha, log_eps, n_accept, t, n_warmup,
                                            target_accept)
            lj_trace.append(_median(lj0))
            if return_trace:
                s_trace.append(s)
        z = assemble(s)
        out = AttrDict(
            theta=constrain_z(program, z),
            z=z,
            z_init=z0,
            state=s,
            accept_rate=n_accept / max(n_steps - n_warmup, 1),
            step_size=torch.exp(log_eps),
            log_joint=log_joint(s),
            log_joint_trace=torch.stack(lj_trace),
            n_warmup=n_warmup,
        )
        if return_trace:
            # post-accept SHARED-block states per step; feeds the mixing
            # diagnostics without materialising the assembled trace
            out["state_trace"] = {k: torch.stack([x[k] for x in s_trace]) for k in ("g", "c", "l")}
        return out


def _adaptive_scales(stats, K, sig_g, sig_c):
    """The adaptive-Metropolis proposal scales of the shared tier: the
    chains' own empirical sd once 50 K draws have accumulated (warmup
    only), q's sd before."""
    n_obs, s1g, s2g, s1c, s2c = stats
    var_g = torch.clamp(s2g / n_obs - (s1g / n_obs) ** 2, min=1e-12)
    var_c = torch.clamp(s2c / n_obs - (s1c / n_obs) ** 2, min=1e-12)
    ready = (n_obs >= 50.0 * K).to(_F32)
    return (ready * torch.sqrt(var_g) + (1.0 - ready) * sig_g,
            ready * torch.sqrt(var_c) + (1.0 - ready) * sig_c)


def _update_stats(stats, adapt, K, zg, zc):
    n_obs, s1g, s2g, s1c, s2c = stats
    return (
        n_obs + adapt * K,
        s1g + adapt * zg.sum(0),
        s2g + adapt * (zg ** 2).sum(0),
        s1c + adapt * zc.sum(1, keepdim=True),
        s2c + adapt * (zc ** 2).sum(1, keepdim=True),
    )


def _stats0(zg0, zc0):
    """(draws counted, then the sums and sums of squares of g and c)."""
    return (torch.tensor(1e-6, dtype=_F32, device=zg0.device),
            torch.zeros_like(zg0[0]), torch.zeros_like(zg0[0]),
            torch.zeros_like(zc0[:, :1, :]), torch.zeros_like(zc0[:, :1, :]))


# --------------------------------------------------------------------------- #
# Pooled Gibbs: locals by per-series HMC | shared by adaptive MH
# --------------------------------------------------------------------------- #
def gibbs_refine_pooled(
    model,
    program,
    params,
    batch,
    key,
    devices=None,
    n_chains=16,
    n_sweeps=2000,
    n_leapfrog=10,
    local_step_scale=0.1,
    shared_step_scale=0.5,
    target_accept_local=0.7,
    target_accept_shared=0.3,
    return_trace=False,
):
    """Exact-joint Gibbs sampler for the pooled hierarchical posterior
    p(shared, locals | all series), built from two conditional updates:

      1. locals | shared — HMC on each series' local block: all L x K
         chains leapfrog together and accept/reject PER (series, chain) on
         that series' own Hamiltonian.  Kinetic mass = the amortised q
         precision per coordinate; per-chain step Robbins-Monro-adapts to
         ``target_accept_local`` during warmup.
      2. shared | locals — adaptive random-walk MH on the (globals,
         conditioned) block with the locals fixed: one batched evaluation
         per sweep; proposal shape follows the chains' own empirical sd
         accumulated during warmup, scalar step adapts to
         ``target_accept_shared``.

    Same state layout, tying and movable policy as ``hmc_refine_pooled``;
    returns the same surface (plus ``accept_rate_local``; ``state_trace``
    holds g and c)."""
    like = batch.observations
    draws = as_draws(key, like.device)
    params = _fixed(params)
    with torch.no_grad():
        L = batch.observations.shape[0]
        K = int(n_chains)
        tiers = _Tiers(program, L, devices, like)
        mg, mc, ml = tiers.mg, tiers.mc, tiers.ml
        log_lik = make_log_lik(model, program, params, batch)
        z0, _, q0 = init_z_from_q(model, program, params, batch, draws, n_chains)  # [L,K,n]
        zg0, zc0, zl0 = tiers.split(z0)

        q_sig = 1.0 / torch.sqrt(torch.clamp(q0.prec, min=1e-12))
        sig_g = q_sig[:, tiers.gsl].mean(0)                                      # [nG]
        sig_c = q_sig.index_select(0, tiers.first_idx)[:, tiers.csl][:, None, :]  # [D, 1, nC]
        qp_l = torch.clamp(q0.prec[:, tiers.lsl], min=1e-8)[:, None, :]         # [L, 1, nL]
        zero_l = torch.zeros_like(qp_l)
        im_l = torch.where(ml > 0, 1.0 / qp_l, zero_l)                           # inverse mass
        p_scale_l = torch.where(ml > 0, torch.sqrt(qp_l), zero_l)

        # frozen shared coordinates stay tied to their representative q draw
        frozen_g, frozen_c, frozen_l = zg0, zc0, z0[:, :, tiers.lsl]

        def assemble(zg, zc, zl):
            g_full = torch.broadcast_to(torch.where(mg > 0, zg, frozen_g)[None],
                                        (L,) + tuple(zg.shape))
            c_full = torch.where(mc > 0, zc, frozen_c).index_select(0, tiers.dev_idx)
            l_full = torch.where(ml > 0, zl, frozen_l)
            return tiers.join(z0, g_full, c_full, l_full)

        def ll_series(zg, zc, zl):                           # [L, K]
            return log_lik(constrain_z(program, assemble(zg, zc, zl)))

        def prior_l(zl):                                     # [L, K]
            return (log_prior_z_cols(program, zl, tiers.idx_l) * ml).sum(-1)

        def prior_gc(zg, zc):                                # [K]
            lp_g = (log_prior_z_cols(program, zg, tiers.idx_g) * mg).sum(-1)
            lp_c = (log_prior_z_cols(program, zc, tiers.idx_c) * mc).sum(-1).sum(0)
            return lp_g + lp_c

        n_warmup = n_sweeps // 2
        base_l = torch.where(ml > 0, 1.0 / torch.sqrt(qp_l), zero_l)

        def pot_grad(zg, zc, zl):
            return _grad(lambda zl_: ll_series(zg, zc, zl_) + prior_l(zl_))(zl) * ml

        ll = ll_series(zg0, zc0, zl0)
        # gradient-scaled initial local step (as in hmc_refine)
        g0l = pot_grad(zg0, zc0, zl0)
        g_scale_l = torch.sqrt(((g0l * base_l) ** 2).sum(-1)).mean(0)  # [K]
        le_l = _log_scalar(local_step_scale, like) - torch.log1p(g_scale_l)
        le_s = torch.full((K,), float(_log_scalar(shared_step_scale, like)), device=like.device)
        stats = _stats0(zg0, zc0)
        zg, zc, zl = zg0, zc0, zl0
        na_l, na_s = torch.zeros(K, device=like.device), torch.zeros(K, device=like.device)
        tgt_trace, g_trace, c_trace = [], [], []
        for t in range(n_sweeps):
            # ---- 1) locals | shared: per-series HMC -------------------------
            step = torch.exp(le_l)[None, :, None] * base_l
            p0 = draws.normal("momentum", tuple(zl.shape), t) * p_scale_l
            lp0 = prior_l(zl)

            p = p0 + 0.5 * step * pot_grad(zg, zc, zl)
            zl_n = zl
            for _ in range(n_leapfrog - 1):
                zl_n = zl_n + step * im_l * p
                p = p + step * pot_grad(zg, zc, zl_n)
            zl_n = zl_n + step * im_l * p
            p = p + 0.5 * step * pot_grad(zg, zc, zl_n)
            ll_n = ll_series(zg, zc, zl_n)
            h0 = -(ll + lp0) + 0.5 * (p0 ** 2 * im_l).sum(-1)
            h1 = -(ll_n + prior_l(zl_n)) + 0.5 * (p ** 2 * im_l).sum(-1)
            log_acc_l = _nan_to_neg_inf(h0 - h1)                          # [L, K]
            acc_l = _accept(draws, "accept_local", log_acc_l, t)
            zl = torch.where(acc_l[:, :, None], zl_n, zl)
            ll = torch.where(acc_l, ll_n, ll)
            alpha_l = torch.clamp(torch.exp(log_acc_l), max=1.0).mean(0)   # [K]

            # ---- 2) shared | locals: adaptive RW-MH -------------------------
            pg_sig, pc_sig = _adaptive_scales(stats, K, sig_g, sig_c)
            e = torch.exp(le_s)
            zg_n = zg + e[:, None] * pg_sig * mg * draws.normal("proposal.g", tuple(zg.shape), t)
            zc_n = zc + e[None, :, None] * pc_sig * mc * draws.normal(
                "proposal.c", tuple(zc.shape), t)
            ll_s = ll_series(zg_n, zc_n, zl)
            log_acc_s = _nan_to_neg_inf(
                (ll_s.sum(0) + prior_gc(zg_n, zc_n)) - (ll.sum(0) + prior_gc(zg, zc)))
            alpha_s = torch.clamp(torch.exp(log_acc_s), max=1.0)
            acc_s = _accept(draws, "accept_shared", log_acc_s, t)
            zg = torch.where(acc_s[:, None], zg_n, zg)
            zc = torch.where(acc_s[None, :, None], zc_n, zc)
            ll = torch.where(acc_s[None, :], ll_s, ll)

            # ---- adaptation (warmup only) -----------------------------------
            adapt = float(t < n_warmup)
            le_l = le_l + adapt * 0.2 * (alpha_l - target_accept_local)
            le_s = le_s + adapt * 0.3 * (alpha_s - target_accept_shared)
            stats = _update_stats(stats, adapt, K, zg, zc)
            counted = float(t >= n_warmup)
            na_l = na_l + counted * acc_l.to(_F32).mean(0)
            na_s = na_s + counted * acc_s.to(_F32)
            tgt_trace.append(_median(ll.sum(0) + prior_gc(zg, zc) + prior_l(zl).sum(0)))
            if return_trace:
                g_trace.append(zg)
                c_trace.append(zc)
        z = assemble(zg, zc, zl)
        out = AttrDict(
            theta=constrain_z(program, z),
            z=z,
            z_init=z0,
            state=dict(g=zg, c=zc, l=zl),
            accept_rate=na_s / max(n_sweeps - n_warmup, 1),
            accept_rate_local=na_l / max(n_sweeps - n_warmup, 1),
            step_size=torch.exp(le_s),
            log_joint=ll.sum(0) + prior_gc(zg, zc) + prior_l(zl).sum(0),
            log_joint_trace=torch.stack(tgt_trace),
            n_warmup=n_warmup,
        )
        if return_trace:
            out["state_trace"] = dict(g=torch.stack(g_trace), c=torch.stack(c_trace))
        return out


# --------------------------------------------------------------------------- #
# Pseudo-marginal MH over the shared tier (locals integrated out)
# --------------------------------------------------------------------------- #
def pm_refine_shared(
    model,
    program,
    params,
    batch,
    key,
    devices=None,
    n_chains=8,
    n_steps=2000,
    n_particles=64,
    rho=0.98,
    step_scale=0.5,
    target_accept=0.3,
    return_trace=False,
):
    """Correlated pseudo-marginal MH targeting the exact MARGINAL posterior
    of the shared tier, p(globals, conditioned | all series), with the local
    sites integrated out by importance sampling from the trained amortised q.

    Per series, p_hat(x_s | shared) = mean_k w_k with
    w_k = p(x_s | shared, l_k) p(l_k) / q(l_k | x_s), l_k ~ q — an unbiased
    estimator, so the chain targets exactly p(shared) prod_s p(x_s | shared)
    [Andrieu & Roberts 2009].  Two alternating MH blocks on the extended
    target pi(z, u) ~ p(z) p_hat(x | z, u) N(u; 0, I):

      A. shared move, u FIXED (the importance-sampling noise cancels);
      B. particle refresh u' = rho u + sqrt(1-rho^2) xi (Crank-Nicolson),
         shared FIXED, accepted INDEPENDENTLY per (series, chain).

    Forward-only: each step evaluates the likelihood twice at L x K x P
    rows.  Returns shared-state samples {g: [K, nG], c: [D, K, nC]},
    optional per-step traces, and full theta whose local coordinates are
    importance-resampled per (series, chain) from the final particle
    weights (an argmax of the weights plus Gumbel noise)."""
    like = batch.observations
    draws = as_draws(key, like.device)
    params = _fixed(params)
    with torch.no_grad():
        L = batch.observations.shape[0]
        P, K = int(n_particles), int(n_chains)
        tiers = _Tiers(program, L, devices, like)
        mg, mc, ml = tiers.mg, tiers.mc, tiers.ml
        nG, nC, n = len(tiers.idx_g), len(tiers.idx_c), program.n_theta
        gsl, csl, lsl = tiers.gsl, tiers.csl, tiers.lsl

        log_lik = make_log_lik(model, program, params, batch)
        q = model.encoder(params["enc"], batch)
        q_mu, q_prec = q.mu, torch.clamp(q.prec, min=1e-12)          # [L, n_theta]
        mu_bb, prec_bb = q_mu[:, None, None, :], q_prec[:, None, None, :]
        q_sig = 1.0 / torch.sqrt(q_prec)
        # random-walk proposal scales: q's (shared-row) sd per coordinate,
        # scaled toward the d-dimensional optimum by step_scale via adaptation
        sig_g = q_sig[:, gsl].mean(0)                                         # [nG]
        sig_c = q_sig.index_select(0, tiers.first_idx)[:, csl][:, None, :]   # [D, 1, nC]

        z0, _, _ = init_z_from_q(model, program, params, batch, draws, n_chains)
        zg0, zc0, _ = tiers.split(z0)
        u0 = draws.normal("particles", (L, K, P, n))

        def assemble(zg, zc, z_loc):                              # [L, K, P, n]
            g_full = torch.broadcast_to(zg[None, :, None, :], (L, K, P, nG))
            c_full = torch.broadcast_to(zc.index_select(0, tiers.dev_idx)[:, :, None, :],
                                        (L, K, P, nC))
            return torch.cat([z_loc[..., lsl], c_full, g_full, z_loc[..., tiers.ksl]], dim=-1)

        def particle_weights(zg, zc, u):
            """Unnormalised particle log-weights log(p(x|th) p(z_l)/q(z_l)),
            [L, K, P]."""
            z_loc = z_from_u(program, u, mu_bb, prec_bb)     # [L, K, P, n]
            theta = constrain_z(program, assemble(zg, zc, z_loc))
            lp_th = log_lik(theta.reshape(L, K * P, n)).reshape(L, K, P)
            lw_l = (
                (log_prior_z_cols(program, z_loc[..., lsl], tiers.idx_l)
                 - log_q_z_sites(program, z_loc, mu_bb, prec_bb)[..., lsl]) * ml
            ).sum(-1)                                        # [L, K, P]
            return _nan_to_neg_inf(lp_th + lw_l)

        def ll_series(zg, zc, u):
            """Per-series log p_hat(x_s | shared), [L, K]."""
            return torch.logsumexp(particle_weights(zg, zc, u), dim=2) - math.log(P)

        def shared_prior(zg, zc):                            # [K]
            lp_g = (log_prior_z_cols(program, zg, tiers.idx_g) * mg).sum(-1)
            lp_c = (log_prior_z_cols(program, zc, tiers.idx_c) * mc).sum(-1).sum(0)
            return lp_g + lp_c

        n_warmup = n_steps // 2
        sq1r = math.sqrt(max(1.0 - rho * rho, 0.0))
        zg, zc, u = zg0, zc0, u0
        ll = ll_series(zg, zc, u)
        lp = shared_prior(zg, zc)
        log_eps = torch.full((K,), float(_log_scalar(step_scale, like)), device=like.device)
        n_accept = n_accept_u = torch.zeros(K, device=like.device)
        stats = _stats0(zg0, zc0)
        tgt_trace, g_trace, c_trace = [], [], []
        for t in range(n_steps):
            pg_sig, pc_sig = _adaptive_scales(stats, K, sig_g, sig_c)
            # A: shared-block RW move, particles fixed (IS noise cancels)
            e = torch.exp(log_eps)                           # [K]
            zg_n = zg + e[:, None] * pg_sig * mg * draws.normal("proposal.g", tuple(zg.shape), t)
            zc_n = zc + e[None, :, None] * pc_sig * mc * draws.normal(
                "proposal.c", tuple(zc.shape), t)
            ll_n = ll_series(zg_n, zc_n, u)
            lp_n = shared_prior(zg_n, zc_n)
            log_alpha = _nan_to_neg_inf((ll_n.sum(0) + lp_n) - (ll.sum(0) + lp))
            alpha = torch.clamp(torch.exp(log_alpha), max=1.0)
            accept = _accept(draws, "accept", log_alpha, t)
            zg = torch.where(accept[:, None], zg_n, zg)
            zc = torch.where(accept[None, :, None], zc_n, zc)
            ll = torch.where(accept[None, :], ll_n, ll)
            lp = torch.where(accept, lp_n, lp)
            # B: Crank-Nicolson particle refresh, shared fixed, accepted
            # independently per (series, chain) — the u-blocks factorise
            u_n = rho * u + sq1r * draws.normal("refresh", tuple(u.shape), t)
            ll_u = ll_series(zg, zc, u_n)
            log_beta = _nan_to_neg_inf(ll_u - ll)  # [L, K]
            accept_u = _accept(draws, "accept_refresh", log_beta, t)
            u = torch.where(accept_u[:, :, None, None], u_n, u)
            ll = torch.where(accept_u, ll_u, ll)
            # adaptation (z-block scalar step + proposal-shape stats), warmup only
            adapt = float(t < n_warmup)
            log_eps = log_eps + adapt * 0.3 * (alpha - target_accept)
            stats = _update_stats(stats, adapt, K, zg, zc)
            counted = float(t >= n_warmup)
            n_accept = n_accept + counted * accept.to(_F32)
            n_accept_u = n_accept_u + counted * accept_u.to(_F32).mean(0)
            tgt_trace.append(_median(ll.sum(0) + lp))
            if return_trace:
                g_trace.append(zg)
                c_trace.append(zc)
        # full theta with the LOCAL coordinates importance-resampled per
        # (series, chain) from the final particle weights
        w_fin = particle_weights(zg, zc, u)                  # [L, K, P]
        p_idx = torch.argmax(w_fin + draws.gumbel("pick", tuple(w_fin.shape)), dim=-1)  # [L, K]
        z_full = assemble(zg, zc, z_from_u(program, u, mu_bb, prec_bb))
        z_final = torch.gather(z_full, 2, p_idx[:, :, None, None].expand(L, K, 1, n))[:, :, 0, :]
        out = AttrDict(
            theta=constrain_z(program, z_final),
            state=dict(g=zg, c=zc),
            state_init=dict(g=zg0, c=zc0),
            accept_rate=n_accept / max(n_steps - n_warmup, 1),
            accept_rate_u=n_accept_u / max(n_steps - n_warmup, 1),
            step_size=torch.exp(log_eps),
            log_target=ll.sum(0) + lp,
            log_target_trace=torch.stack(tgt_trace),
            n_warmup=n_warmup,
        )
        if return_trace:
            out["state_trace"] = dict(g=torch.stack(g_trace), c=torch.stack(c_trace))
        return out


# --------------------------------------------------------------------------- #
# SMC
# --------------------------------------------------------------------------- #
def _systematic_resample(u0, log_w):
    """Systematic resampling indices [..., K] for particles' log-weights
    ``log_w [..., K]`` and one uniform ``u0 [...]`` per row.  In float32
    (u0 + K - 1) / K rounds to 1.0 for u0 within ~2^(log2 K - 24) of 1,
    above a cumulated softmax that ends just below 1.0: ``searchsorted``
    then says K, and the index is clamped to the last particle."""
    K = log_w.shape[-1]
    cdf = torch.cumsum(torch.softmax(log_w, dim=-1), dim=-1)
    pts = (u0[..., None] + torch.arange(K, dtype=log_w.dtype, device=log_w.device)) / K
    return torch.clamp(torch.searchsorted(cdf.contiguous(), pts.contiguous()), max=K - 1)


def smc_refine(
    model,
    program,
    params,
    batch,
    key,
    n_particles=64,
    n_temps=10,
    n_moves=1,
    n_leapfrog=3,
    step_scale=0.05,
    ess_threshold=0.5,
):
    """Annealed SMC from the amortised q to the posterior.

    Bridging targets pi_beta ~ q(z)^(1-beta) [p(z) p(x|T(z))]^beta with a
    linear beta ladder; systematic resampling when ESS < threshold*K; ``n_moves``
    HMC moves targeting pi_beta after each reweighting.  Also returns an
    unbiased log-evidence estimate per datapoint (the SMC normalising-constant
    telescope)."""
    like = batch.observations
    draws = as_draws(key, like.device)
    params = _fixed(params)
    with torch.no_grad():
        log_joint = make_log_joint(model, program, params, batch)
        mask = _sampled_mask(program, like)
        prior_prec = program._t("prior_prec", like)
        inv_mass = torch.where(mask > 0, 1.0 / prior_prec, torch.zeros_like(prior_prec))
        step0 = step_scale * torch.where(mask > 0, 1.0 / torch.sqrt(prior_prec),
                                         torch.zeros_like(prior_prec))

        z, _, q = init_z_from_q(model, program, params, batch, draws, n_particles)
        q_mu, q_prec = q.mu[:, None, :], q.prec[:, None, :]

        def log_q_z(z):
            return (log_q_z_sites(program, z, q_mu, q_prec) * mask).sum(-1)

        def log_pi(z, beta):
            return beta * log_joint(z) + (1.0 - beta) * log_q_z(z)

        def hmc_move(z, beta, t, m):
            grad_log_pi = _grad(lambda z_: log_pi(z_, beta))
            step = step0
            p = draws.normal("momentum", tuple(z.shape), t, m) * torch.sqrt(prior_prec) * mask
            lj0 = log_pi(z, beta)
            ke0 = 0.5 * (p ** 2 * inv_mass).sum(-1)
            g = grad_log_pi(z) * mask
            p_h = p + 0.5 * step * g
            z_n = z
            for _ in range(n_leapfrog - 1):
                z_n = z_n + step * inv_mass * p_h
                p_h = p_h + step * (grad_log_pi(z_n) * mask)
            z_n = z_n + step * inv_mass * p_h
            p_h = p_h + 0.5 * step * (grad_log_pi(z_n) * mask)
            lj1 = log_pi(z_n, beta)
            ke1 = 0.5 * (p_h ** 2 * inv_mass).sum(-1)
            accept = _accept(draws, "accept", (lj1 - ke1) - (lj0 - ke0), t, m)
            return torch.where(accept[:, :, None], z_n, z), accept

        # the beta ladder in float32, as jnp.linspace lays it
        betas = torch.linspace(0.0, 1.0, n_temps + 1, dtype=_F32, device=like.device)
        B, K = z.shape[0], z.shape[1]
        log_w = torch.zeros((B, K), device=like.device)
        log_Z = torch.zeros(B, device=like.device)
        ess_trace, acc_trace = [], []
        for t in range(n_temps):
            beta_prev, beta = betas[t], betas[t + 1]
            # incremental weights: pi_beta / pi_beta_prev = [p(x,z)/q(z)]^(beta-beta_prev)
            log_w = log_w + (beta - beta_prev) * (log_joint(z) - log_q_z(z))
            # normalise + record evidence increment
            lse = torch.logsumexp(log_w, dim=1, keepdim=True)
            log_Z = log_Z + lse[:, 0] - math.log(K)
            log_w_n = log_w - lse
            # ESS <= n_particles mathematically; float32 logsumexp noise can push
            # the near-uniform-weight case a few 1e-4 over, so clamp.
            ess = torch.clamp(1.0 / torch.sum(torch.exp(2.0 * log_w_n), dim=1), max=float(K))
            need = ess < ess_threshold * K
            idx = _systematic_resample(draws.uniform("resample", (B,), t), log_w_n)
            z_res = torch.gather(z, 1, idx[:, :, None].expand(B, K, z.shape[2]))
            z = torch.where(need[:, None, None], z_res, z)
            log_w = torch.where(need[:, None], torch.zeros_like(log_w), log_w - lse)
            acc_sum = torch.zeros((B, K), device=like.device)
            for m in range(n_moves):
                z, acc = hmc_move(z, beta, t, m)
                acc_sum = acc_sum + acc
            ess_trace.append(ess)
            acc_trace.append(acc_sum.mean() / max(n_moves, 1))
        return AttrDict(
            theta=constrain_z(program, z),
            z=z,
            log_w=log_w,
            log_evidence=log_Z,
            ess_trace=torch.stack(ess_trace),
            accept_trace=torch.stack(acc_trace),
        )
