"""Model base layer: constant and neural precisions, the device conditioner,
simulate.

Stateless model objects with explicit param dicts and functions over
[B, K, ...] tensors, as in ``vihds_tpu.models.base``.
"""

import torch

from vihds_tpu_torch.nn import layers
from vihds_tpu_torch.ops.logprob import log_prob_gaussian, log_prob_laplace
from vihds_tpu_torch.ops.solvers import FIXED_GRID_SOLVERS, integrate, integrate_fold
from vihds_tpu_torch.utils import default_get_value


def power(x, a):
    return x ** a


def transform_treatments(treatments):
    """Invert the dataset's log1p transform, clamped."""
    return torch.clamp(torch.exp(treatments) - 1.0, 1e-12, 1e6)


def split_treatments(treatments, n):
    """treatments[B, C] -> n broadcastable [B, 1] columns."""
    tt = transform_treatments(treatments)
    return [tt[:, i : i + 1] for i in range(n)]


def rhs_from_cols(rhs_cols, c, n_species, precisions, prec_params):
    """The generic solver's RHS over state[..., S] from a fused kind's plain
    right-hand side ``rhs_cols`` over [n_species, ...] columns (the kernels'
    own arithmetic), with the precision block when the precisions are
    states."""

    def rhs(t, state):
        dX = rhs_cols(c, t, state[..., :n_species].movedim(-1, 0)).movedim(0, -1)
        if precisions.dynamic:
            return torch.cat([dX, precisions.rhs(prec_params, t, state, None)], dim=-1)
        return dX

    return rhs


def with_prec_state0(mech, theta, n_batch, n_iwae):
    """The mechanistic initial state [B, K, NS] of a ``_precisions`` model
    followed by its 4 precision states' initial values."""
    precs = [torch.broadcast_to(theta[v], (n_batch, n_iwae))
             for v in ("init_prec_x", "init_prec_rfp", "init_prec_yfp", "init_prec_cfp")]
    return torch.cat([mech, torch.stack(precs, dim=-1)], dim=-1)


class ConstantPrecisions:
    """Observation precisions are latent thetas, constant over time."""

    dynamic = False

    def __init__(self, precision_vars):
        self.precision_vars = precision_vars

    def init_params(self, generator):
        return {}

    def expand(self, params, theta, n_times, x_states):
        """x_states[B,K,S,T] -> (states, precisions[B,K,P,1] broadcastable to T)."""
        precisions = torch.stack([theta[v] for v in self.precision_vars], dim=-1)
        return x_states, precisions[:, :, :, None]

    def at_time(self, params, theta, y):
        """Single-time counterpart of ``expand``: y[B,K,S] at one grid point
        -> (states[B,K,S], precisions[B,K,P])."""
        return y, torch.stack([theta[v] for v in self.precision_vars], dim=-1)


class NeuralPrecisions:
    """Precisions as extra ODE states with learned production/degradation
    nets: dprec/dt = N1(t, x, c) - N2(t, x, c) * prec."""

    dynamic = True

    def __init__(self, n_inputs, n_hidden_precisions, n_outputs=4, inverse=False, activation="tanh"):
        self.n_inputs = n_inputs
        self.n_hidden = n_hidden_precisions
        self.n_outputs = n_outputs
        self.inverse = inverse
        self.activation = torch.tanh if activation == "tanh" else torch.relu

    def init_params(self, generator):
        n_in = self.n_inputs + 1  # +1 for time
        if self.n_hidden < 1:
            return {
                "prod": layers.linear_init(generator, n_in, self.n_outputs, mode="xavier"),
                "degr": layers.linear_init(generator, n_in, self.n_outputs, mode="xavier"),
            }
        return {
            "hidden": layers.linear_init(generator, n_in, self.n_hidden, mode="xavier"),
            "prod": layers.linear_init(generator, self.n_hidden, self.n_outputs, mode="xavier",
                                       gain=0.5),
            "degr": layers.linear_init(generator, self.n_hidden, self.n_outputs, mode="xavier",
                                       gain=1.0),
        }

    def rhs(self, params, t, state, constants):
        """state[B,K,S_total] -> dprec[B,K,n_outputs]; the activation covers
        the whole input [t, species(, constants)].  ``t`` is a scalar or,
        under per-fold adaptive control, each row's time [B, 1]."""
        s = state[..., : -self.n_outputs]
        var_state = state[..., -self.n_outputs :]
        t = torch.as_tensor(t, dtype=state.dtype, device=state.device)
        t_exp = torch.broadcast_to(t[..., None] if t.dim() else t, state.shape[:-1] + (1,))
        parts = [t_exp, s] if constants is None else [t_exp, s, constants]
        x = torch.cat(parts, dim=-1)
        if self.n_hidden < 1:
            h = self.activation(x)
        else:
            h = self.activation(layers.linear_apply(params["hidden"], x))
        xa = torch.sigmoid(layers.linear_apply(params["prod"], h))
        xd = torch.sigmoid(layers.linear_apply(params["degr"], h))
        return xa - xd * var_state

    def expand(self, params, theta, n_times, x_states):
        """Split the trailing precision states off x_states[B,K,S,T]."""
        prec = x_states[:, :, -self.n_outputs :, :]
        if self.inverse:
            prec = 1.0 / prec
        return x_states[:, :, : -self.n_outputs, :], prec

    def at_time(self, params, theta, y):
        """Single-time counterpart of ``expand``: split the trailing
        precision states off y[B,K,S_total]."""
        prec = y[..., -self.n_outputs :]
        if self.inverse:
            prec = 1.0 / prec
        return y[..., : -self.n_outputs], prec


class NeuralStates:
    """Black-box RHS: dx = sigmoid(prod(h)) - sigmoid(degr(h)) * x with
    h = relu(hidden([x, constants]))."""

    def __init__(self, n_inputs, n_hidden, n_states, n_latents):
        self.n_inputs = n_inputs
        self.n_hidden = n_hidden
        self.n_states = n_states
        self.n_latents = n_latents

    def init_params(self, generator):
        return {
            "hidden": layers.linear_init(generator, self.n_inputs, self.n_hidden, mode="xavier"),
            "prod": layers.linear_init(generator, self.n_hidden, self.n_states, mode="xavier"),
            "degr": layers.linear_init(generator, self.n_hidden, self.n_states, mode="xavier"),
        }

    def __call__(self, params, x, constants):
        aug = torch.cat([x, constants], dim=-1)
        hidden = torch.relu(layers.linear_apply(params["hidden"], aug))
        return torch.sigmoid(layers.linear_apply(params["prod"], hidden)) - torch.sigmoid(
            layers.linear_apply(params["degr"], hidden)
        ) * x


class OdeModel:
    """Base class for mechanistic device models.

    The device-conditioner weights are persistent params created once in
    ``init_params``."""

    def __init__(self, config):
        self.device_depth = config.data.device_depth
        self.n_treatments = len(config.data.conditions)
        self.use_laplace = default_get_value(config.params, "use_laplace", False)
        self.relevance = config.data.relevance_vectors
        self.default_devices = config.data.default_devices
        self.solver = config.params.solver
        # optional solver for the evaluation path; 'pallas_<method>' routes
        # families with a fused kernel (pallas_kinds) through it
        self.eval_solver = default_get_value(config.params, "eval_solver", None)
        self.adjoint = bool(config.params.adjoint_solver)
        self.precisions = None
        self.species = None
        self.n_species = None
        # parameters the device conditioner applies to (set by subclasses)
        self.conditioned_params = ()

    # ------------------------------------------------------------- parameters
    def init_params(self, generator):
        p = {}
        for name in self.conditioned_params:
            p["cond_" + name] = layers.linear_init(
                generator, self.device_depth, 1, use_bias=False, mode="normal"
            )
        pk = self.precisions.init_params(generator) if self.precisions is not None else {}
        if pk:
            p["precisions"] = pk
        return p

    # ------------------------------------------------------------ conditioning
    def device_conditioner(self, params, param, param_name, dev_1hot):
        """param_cond = relu(W (dev_1hot * relevance)); multiplies ``param``
        ((1 + f) for default devices)."""
        # uploaded once per device: a copy from the host each call would wait
        # for the device's queue
        cache = self.__dict__.setdefault("_relevance_tensors", {})
        key = (param_name, dev_1hot.device)
        if key not in cache:
            cache[key] = torch.as_tensor(self.relevance[param_name], device=dev_1hot.device)
        relevance = cache[key]
        cond = torch.relu(layers.linear_apply(params["cond_" + param_name], dev_1hot * relevance))
        # cond: [B, 1], broadcasts over the IWAE axis
        if param_name in self.default_devices:
            return param * (1.0 + cond)
        return param * cond

    def condition_theta(self, params, theta, dev_1hot):
        """Apply the device conditioner to each grouped parameter."""
        for name in self.conditioned_params:
            theta[name] = self.device_conditioner(params, 1.0, name, dev_1hot)
        return theta

    # -------------------------------------------------------------- simulation
    def initialize_state(self, params, theta, treatments, n_batch, n_iwae):
        raise NotImplementedError

    def make_rhs(self, params, theta, treatments, dev_1hot):
        raise NotImplementedError

    def _solver_for(self, eval_mode):
        if eval_mode and self.eval_solver:
            return self.eval_solver
        return self.solver

    # families with a fused kernel (plain_kind, prec_kind) implement
    # _pallas_constants; see vihds_tpu_torch/ops/fused_ode.py
    pallas_kinds = None

    def _pallas_constants(self, theta, treatments):
        """Per-sample constants dict in the packed order the family's kernel
        expects ([B, K]-broadcastable leaves)."""
        raise NotImplementedError

    def _pallas_supported(self):
        """The fused kernels cover ConstantPrecisions and the shipped
        NeuralPrecisions configuration (n_hidden=0, tanh, non-inverse, 4
        outputs: the learned-precision block runs in the kernel).  Any other
        configuration takes the generic solver, as the JAX package's gate
        decides; this is a choice of configuration, made before any launch."""
        p = self.precisions
        if not p.dynamic:
            return True
        return (
            isinstance(p, NeuralPrecisions)
            and p.n_hidden < 1
            and not p.inverse
            and p.activation is torch.tanh
            and p.n_outputs == 4
        )

    def simulate(self, params, theta, times, treatments, dev_1hot, n_iwae, eval_mode=False,
                 folds=None):
        """Integrate and return x_states[B, K, S, T].  ``solver:
        pallas_<method>`` (or ``eval_solver`` in eval mode) routes families
        that declare ``pallas_kinds`` through the fused CUDA integrator,
        which is differentiable (its backward is a kernel too); any other
        family or configuration takes the same fixed-grid method on the
        generic solver.  Adaptive methods and ``adjoint_solver: true`` take
        the continuous adjoint (``ops.adjoint``).  ``folds``: the fold count
        of a fold-batched step (rows fold-major), which gives an adaptive
        method a step controller per fold."""
        n_batch = treatments.shape[0]
        method = self._solver_for(eval_mode)
        if method.startswith("pallas_"):
            method = method[len("pallas_"):]
            if self.pallas_kinds and self._pallas_supported():
                from vihds_tpu_torch.ops import fused_ode

                dynamic = self.precisions.dynamic
                y0 = torch.broadcast_to(
                    self.initialize_state(params, theta, treatments, n_batch, n_iwae),
                    (n_batch, n_iwae, self.n_species + (4 if dynamic else 0)),
                )
                sol = fused_ode.simulate_kind(
                    self.pallas_kinds[1 if dynamic else 0],
                    self._pallas_constants(theta, treatments),
                    y0,
                    times,
                    method=method,
                    prec_params=params.get("precisions") if dynamic else None,
                )
                return sol.permute(1, 2, 3, 0)
        init_state = self.initialize_state(params, theta, treatments, n_batch, n_iwae)
        # the right-hand side's builder and arguments: the adjoint route
        # (adaptive methods, adjoint_solver) hands its gradient to each tensor
        rhs = (self.make_rhs, (params, theta, treatments, dev_1hot))
        sol = integrate(rhs, init_state, times, method=method, adjoint=self.adjoint,
                        folds=folds)  # [T,B,K,S]
        return sol.permute(1, 2, 3, 0)

    def supports_fold(self):
        """True when the training objective can run through the online
        log-likelihood route (``simulate_logprob``): fixed-grid solvers
        only; the fused ``pallas_*`` route keeps the trajectory route."""
        return (self.solver in FIXED_GRID_SOLVERS) and not self.adjoint

    def simulate_logprob(self, params, theta, times, treatments, dev_1hot, n_iwae,
                         observations, use_laplace=False):
        """Observation log-likelihood by species [B, K, S_obs] accumulated
        online, step by step (``ops.solvers.integrate_fold``): the same
        ``sum_t log p(x_t | y_t)`` the trajectory route computes, without the
        [B, K, S, T] trajectory.  ``observe`` indexes [:, :, i, :], so one
        trailing singleton time axis makes it a per-time map."""
        n_batch = treatments.shape[0]
        y0 = self.initialize_state(params, theta, treatments, n_batch, n_iwae)
        rhs = self.make_rhs(params, theta, treatments, dev_1hot)
        prec_params = params.get("precisions", {})
        lp = log_prob_laplace if use_laplace else log_prob_gaussian

        def fold(y, obs_t):
            states, prec = self.precisions.at_time(prec_params, theta, y)
            pred = self.observe(states[..., None], theta)[..., 0]  # [B,K,4]
            return lp(obs_t[:, None, :], pred, prec)

        obs_tbs = observations.permute(2, 0, 1)  # [T, B, S]
        _, acc = integrate_fold(rhs, y0, times, fold, obs_tbs, method=self.solver)
        return acc

    def observe(self, x_states, theta):
        """Default 8-state observation map."""
        x = x_states
        return torch.stack(
            [
                x[:, :, 0, :],
                x[:, :, 0, :] * x[:, :, 1, :],
                x[:, :, 0, :] * (x[:, :, 2, :] + x[:, :, 4, :]),
                x[:, :, 0, :] * (x[:, :, 3, :] + x[:, :, 5, :]),
            ],
            dim=2,
        )

    def expand_precisions(self, params, theta, n_times, x_states):
        return self.precisions.expand(params.get("precisions", {}), theta, n_times, x_states)
