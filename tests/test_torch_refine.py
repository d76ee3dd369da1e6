"""The port's samplers (``vihds_tpu_torch.refine``) against the JAX package's
(``vihds_tpu.refine``) on the CPU, step for step.

Both packages' ``make_log_lik`` are replaced by one analytic likelihood (a
Gaussian in asinh(theta) about a per-series target), the way
``tests/test_refine.py`` replaces it, so the samplers' machinery is held
against JAX without running a JAX sampler on the ODE (the ODE's log-joint
and its gradient are held in ``tests/test_torch_refine_model.py``).  The
spec is dr_constant_one, 3 series, the JAX package's initial params
converted; each JAX sampler runs under ``jax.jit``.  The port is handed
``JaxKeys``: a source of draws that replays
the JAX package's key schedule of each sampler (``jax.random.split`` /
``fold_in`` as ``vihds_tpu/refine.py`` uses them), so both take the same
steps on the same draws.

Tolerance: states, theta, step sizes, acceptance rates, traces, log
evidence and ESS to rtol 1e-4, atol 1e-6.  Each Metropolis decision must be
equal wherever its margin |log u - log alpha| exceeds 1e-4 (JAX's log alpha,
read where ``jnp.nan_to_num`` takes it; SMC's moves take no nan_to_num, so
there the port's); where a decision lies inside that margin the test says
so and compares only the steps before it.

Also here: ``_systematic_resample``, with the reference's out-of-range
index.  The site functions and the places where a port drifts without an
error are held in tests/test_torch_refine_sites.py.  The JAX reference
runs are shared through module fixtures."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_args, spec
from vihds_tpu import refine as jref
from vihds_tpu.config import Config as JConfig
from vihds_tpu.data.datasets import build_datasets as j_build
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu.training import batch_arrays
from vihds_tpu.vae import VAE as JVAE
from vihds_tpu_torch import refine as tref
from vihds_tpu_torch import training as T
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.convert import params_from_jax
from vihds_tpu_torch.data.datasets import build_datasets as t_build
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.vae import VAE as TVAE

N_SERIES = 3
RTOL, ATOL = 1e-4, 1e-6
#: a Metropolis decision closer than this to its threshold may flip
MARGIN = 1e-4
#: the pooled samplers' device per series: two devices
DEVICES = [0, 1, 1]


# --------------------------------------------------------------------------- #
# Both packages on one problem
# --------------------------------------------------------------------------- #
def _torch_setup(yaml_path, jparams, host):
    targs = SimpleNamespace(yaml=yaml_path, seed=0, folds=4, split=1, heldout=None)
    tset = TConfig(targs)
    tprog = TProgram(t_parse(tset.params))
    tmodel = TVAE(tset, t_build(targs, tset), tprog)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    batch = T.batch_tensors(host, slice(None), torch.as_tensor(host.times), "cpu")
    return tprog, tmodel, tparams, batch


@pytest.fixture(scope="module")
def both():
    """dr_constant_one on 3 series in both packages, the same params."""
    args = make_args(spec("dr_constant_one.yaml"))
    jset = JConfig(args)
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    jmodel = JVAE(jset, jdata, jprog)
    jparams = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    host = jdata.train.dataset.select(np.arange(N_SERIES))
    jbatch = batch_arrays(host)
    tprog, tmodel, tparams, tbatch = _torch_setup(spec("dr_constant_one.yaml"), jparams, host)
    # the analytic likelihood's weights and targets in asinh(theta)
    movable = ~jprog.is_constant
    weight = np.where(movable, 2.0, 0.0).astype(np.float32)
    center = np.where(jprog.is_lognormal, np.exp(jprog.prior_mu), jprog.prior_mu)
    target = (np.arcsinh(center) + 0.3).astype(np.float32)
    return SimpleNamespace(j=(jmodel, jprog, jparams, jbatch), t=(tmodel, tprog, tparams, tbatch),
                           weight=weight, target=target)


def _jax_lik(weight, target):
    def make(model, program, params, batch):
        off = 0.1 * batch.observations.mean(axis=(1, 2))[:, None, None]

        def ll(theta):
            return -0.5 * (jnp.asarray(weight)
                           * (jnp.arcsinh(theta) - jnp.asarray(target) - off) ** 2).sum(-1)

        return ll

    return make


def _torch_lik(weight, target):
    def make(model, program, params, batch):
        off = 0.1 * batch.observations.mean(dim=(1, 2))[:, None, None]
        w, c = torch.as_tensor(weight), torch.as_tensor(target)

        def ll(theta):
            return -0.5 * (w * (torch.asinh(theta) - c - off) ** 2).sum(-1)

        return ll

    return make


# --------------------------------------------------------------------------- #
# The JAX package's key schedules, replayed
# --------------------------------------------------------------------------- #
def _split(key, n=2):
    return jax.random.split(key, n)


def hmc_keys(key, n_steps):
    """hmc_refine / hmc_refine_pooled (refine.py:339, 386, 411; 529, 605, 640, 665)."""
    key, k0 = _split(key)
    keys = _split(key, n_steps)

    def at(name, t=None):
        if name == "init":
            return k0
        k_mom, k_acc = _split(keys[t])
        if name == "accept":
            return k_acc
        if name == "momentum":
            return k_mom
        return _split(k_mom, 3)["gcl".index(name[-1])]  # momentum.g|c|l

    return at


def gibbs_keys(key, n_sweeps):
    """gibbs_refine_pooled (refine.py:755, 805, 886)."""
    key, k0 = _split(key)
    keys = _split(key, n_sweeps)
    names = ("momentum", "accept_local", "proposal.g", "proposal.c", "accept_shared")

    def at(name, t=None):
        return k0 if name == "init" else _split(keys[t], 5)[names.index(name)]

    return at


def pm_keys(key, n_steps):
    """pm_refine_shared (refine.py:1006, 1049, 1108, 1128)."""
    key, k0, ku0 = _split(key, 3)
    keys = _split(key, n_steps)
    names = ("proposal.g", "proposal.c", "accept", "refresh", "accept_refresh")

    def at(name, t=None):
        if name == "init":
            return k0
        if name == "particles":
            return ku0
        if name == "pick":
            return jax.random.fold_in(key, 0x7E5A)
        return _split(keys[t], 5)[names.index(name)]

    return at


def smc_keys(key, n_temps, n_moves, n_series):
    """smc_refine (refine.py:1192, 1206, 1239, 1241, 1251)."""
    key, k0 = _split(key)
    keys = _split(key, n_temps)

    def at(name, t=None, m=None):
        if name == "init":
            return k0
        k_res, *k_moves = _split(keys[t], 1 + n_moves)
        if name == "resample":
            return _split(k_res, n_series)  # one key a series
        k_mom, k_acc = _split(k_moves[m])
        return k_mom if name == "momentum" else k_acc

    return at


class JaxKeys:
    """A source of draws (``vihds_tpu_torch.refine.Draws``'s interface) that
    replays a JAX key schedule ``at(name, *index) -> key``; records its
    uniforms by (name, *index)."""

    def __init__(self, at):
        self.at = at
        self.uniforms = {}

    def normal(self, name, shape, *index):
        return torch.from_numpy(np.array(
            jax.random.normal(self.at(name, *index), shape, jnp.float32)))

    def uniform(self, name, shape, *index):
        key = self.at(name, *index)
        if name == "resample":
            u = jax.vmap(lambda k: jax.random.uniform(k, ()))(key)
        else:
            u = jax.random.uniform(key, shape)
        self.uniforms[(name,) + index] = np.array(u)
        return torch.from_numpy(np.array(u))

    def gumbel(self, name, shape, *index):
        return torch.from_numpy(np.array(jax.random.gumbel(self.at(name, *index), shape)))


# --------------------------------------------------------------------------- #
# One run of a sampler in both packages
# --------------------------------------------------------------------------- #
def _run_both(both, sampler, keys_of, jax_log_alphas, seed, **kw):
    """(JAX's output as numpy, the port's as numpy, the port's Metropolis
    records [(name, index, log u, log alpha port)], JAX's log alphas as its
    ``jnp.nan_to_num`` took them, in order, where ``jax_log_alphas``).  The
    analytic likelihood replaces make_log_lik in both packages."""
    recorded = []

    def record(v):
        recorded.append(np.asarray(v))

    nan_to_num = jnp.nan_to_num

    def spy(x, *a, **k):
        jax.debug.callback(record, x, ordered=True)
        return nan_to_num(x, *a, **k)

    port_records = []
    accept = tref._accept

    def port_accept(draws, name, log_alpha, *index):
        out = accept(draws, name, log_alpha, *index)
        port_records.append((name, index, np.log(draws.uniforms[(name,) + index]),
                             log_alpha.numpy().copy()))
        return out

    key = jax.random.PRNGKey(seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jref, "make_log_lik", _jax_lik(both.weight, both.target))
        mp.setattr(tref, "make_log_lik", _torch_lik(both.weight, both.target))
        if jax_log_alphas:
            mp.setattr(jnp, "nan_to_num", spy)
        mp.setattr(tref, "_accept", port_accept)
        # the JAX sampler under one jit: one XLA compile, not one per eager op
        jmodel, jprog, jparams, jbatch = both.j
        jout = jax.jit(lambda p, b, k: getattr(jref, sampler)(jmodel, jprog, p, b, k, **kw))(
            jparams, jbatch, key)
        jax.effects_barrier()
        tout = getattr(tref, sampler)(*both.t, JaxKeys(keys_of(key)), **kw)
    return _numpy(jout), _numpy(tout), port_records, recorded


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.numpy()
    return np.asarray(tree) if not isinstance(tree, int) else tree


def _first_close_step(port_records, jax_alphas):
    """Check the decisions; return the first step whose decision lies inside
    the margin (None where none does).  ``jax_alphas``: JAX's log alphas in
    the port's order of decisions, or None (the port's stand in)."""
    close = None
    for i, (name, index, log_u, alpha_port) in enumerate(port_records):
        alpha = alpha_port if jax_alphas is None else jax_alphas[i]
        assert alpha.shape == alpha_port.shape, (name, index)
        # float32 as both packages compare
        log_u = log_u.astype(np.float32)
        wide = np.abs(log_u - alpha) > MARGIN
        np.testing.assert_array_equal((log_u < alpha_port)[wide], (log_u < alpha)[wide],
                                      err_msg="decision %s %s" % (name, index))
        if not wide.all() and close is None:
            close = index[0]
    if close is not None:
        print("a Metropolis decision at step %d lies within %g of its threshold: "
              "comparing the steps before it only" % (close, MARGIN))
    return close


def _compare(jout, tout, traces, finals, close):
    """Traces [n_steps, ...] up to the first close step, final outputs only
    where no decision was close."""
    for name in traces:
        want, got = jout, tout
        for part in name.split("."):
            want, got = want[part], got[part]
        upto = slice(None) if close is None else slice(0, close)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got[upto], want[upto], rtol=RTOL, atol=ATOL, err_msg=name)
    if close is None:
        for name in finals:
            want, got = jout, tout
            for part in name.split("."):
                want, got = want[part], got[part]
            assert np.shape(got) == np.shape(want), name
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


def _pair(port_records, jax_alphas, ndims):
    """JAX's recorded nan_to_num arguments whose ndim is in ``ndims`` (the
    log alphas; the pseudo-marginal particle weights also pass there), one
    per port decision, shapes checked."""
    alphas = [a for a in jax_alphas if a.ndim in ndims]
    assert len(alphas) == len(port_records)
    return alphas


HMC_KW = dict(n_chains=4, n_steps=8, n_leapfrog=3)


@pytest.fixture(scope="module")
def hmc_run(both):
    program = both.t[1]
    local_mask = np.zeros(program.n_theta, np.float32)
    sl = program.local_slice
    local_mask[sl] = (program.is_normal_family & ~program.is_constant)[sl]
    return _run_both(both, "hmc_refine", lambda k: hmc_keys(k, HMC_KW["n_steps"]), True, 1,
                     site_mask=local_mask, return_trace=True, **HMC_KW)


@pytest.fixture(scope="module")
def hmc_adapt_run(both):
    kw = dict(HMC_KW, n_steps=12)
    return _run_both(both, "hmc_refine", lambda k: hmc_keys(k, kw["n_steps"]), True, 9,
                     mass_from_q=True, adapt_mass=True, init_inflate=1.5, **kw)


@pytest.fixture(scope="module")
def pooled_run(both):
    return _run_both(both, "hmc_refine_pooled", lambda k: hmc_keys(k, HMC_KW["n_steps"]), True,
                     5, devices=DEVICES, return_trace=True, **HMC_KW)


@pytest.fixture(scope="module")
def gibbs_run(both):
    return _run_both(both, "gibbs_refine_pooled", lambda k: gibbs_keys(k, 8), True, 13,
                     devices=DEVICES, n_chains=4, n_sweeps=8, n_leapfrog=3, return_trace=True)


@pytest.fixture(scope="module")
def pm_run(both):
    return _run_both(both, "pm_refine_shared", lambda k: pm_keys(k, 8), True, 11,
                     devices=DEVICES, n_chains=4, n_steps=8, n_particles=4, return_trace=True)


@pytest.fixture(scope="module")
def smc_run(both):
    return _run_both(both, "smc_refine", lambda k: smc_keys(k, 3, 2, N_SERIES), False, 3,
                     n_particles=4, n_temps=3, n_moves=2)


def test_hmc_refine_with_trace_and_site_mask(hmc_run):
    jout, tout, port, jax_alphas = hmc_run
    close = _first_close_step(port, _pair(port, jax_alphas, (2,)))
    _compare(jout, tout, ["z_trace", "log_joint_trace"],
             ["z", "z_init", "theta", "accept_rate", "step_size", "log_joint"], close)
    assert tout["n_warmup"] == jout["n_warmup"] == 4
    # the frozen (unmasked) sites keep their amortised draw
    frozen = np.ones(tout["z"].shape[-1], bool)
    frozen[:4] = False
    np.testing.assert_array_equal(tout["z"][..., frozen], tout["z_init"][..., frozen])
    assert 0 < tout["accept_rate"].mean() <= 1


def test_hmc_refine_mass_from_q_adapt_mass_inflate(hmc_adapt_run):
    jout, tout, port, jax_alphas = hmc_adapt_run
    close = _first_close_step(port, _pair(port, jax_alphas, (2,)))
    _compare(jout, tout, ["log_joint_trace"],
             ["z", "z_init", "theta", "accept_rate", "step_size", "log_joint"], close)


def test_hmc_refine_pooled_two_devices(pooled_run):
    jout, tout, port, jax_alphas = pooled_run
    close = _first_close_step(port, _pair(port, jax_alphas, (1,)))
    _compare(jout, tout, ["state_trace.g", "state_trace.c", "state_trace.l", "log_joint_trace"],
             ["z", "z_init", "theta", "state.g", "state.c", "state.l", "accept_rate",
              "step_size", "log_joint"], close)
    assert tout["state"]["c"].shape[0] == 2
    th = tout["theta"]
    g = slice(6, 31)
    np.testing.assert_array_equal(th[:, :, g], np.broadcast_to(th[0:1, :, g], th[:, :, g].shape))
    # the conditioned sites are tied within each device
    np.testing.assert_array_equal(th[1, :, 4:6], th[2, :, 4:6])


def test_gibbs_refine_pooled(gibbs_run):
    jout, tout, port, jax_alphas = gibbs_run
    close = _first_close_step(port, _pair(port, jax_alphas, (1, 2)))
    _compare(jout, tout, ["state_trace.g", "state_trace.c", "log_joint_trace"],
             ["z", "z_init", "theta", "state.g", "state.c", "state.l", "accept_rate",
              "accept_rate_local", "step_size", "log_joint"], close)


def test_pm_refine_shared(pm_run):
    jout, tout, port, jax_alphas = pm_run
    close = _first_close_step(port, _pair(port, jax_alphas, (1, 2)))
    _compare(jout, tout, ["state_trace.g", "state_trace.c", "log_target_trace"],
             ["theta", "state.g", "state.c", "state_init.g", "state_init.c", "accept_rate",
              "accept_rate_u", "step_size", "log_target"], close)


def test_smc_refine(smc_run):
    jout, tout, port, _ = smc_run
    close = _first_close_step(port, None)
    _compare(jout, tout, ["ess_trace", "accept_trace"],
             ["z", "theta", "log_w", "log_evidence"], close)
    assert (tout["ess_trace"] <= 4).all()


def test_default_draws_give_the_same_chains_twice(both):
    """An integer key seeds ``Draws`` (a torch.Generator): the same seed gives
    the same chains bit for bit."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tref, "make_log_lik", _torch_lik(both.weight, both.target))
        runs = [tref.hmc_refine_pooled(*both.t, 7, devices=DEVICES, n_chains=2, n_steps=3,
                                       n_leapfrog=2) for _ in range(2)]
    for k in ("g", "c", "l"):
        assert torch.equal(runs[0].state[k], runs[1].state[k])
    assert torch.isfinite(runs[0].theta).all()


# --------------------------------------------------------------------------- #
# (d) Systematic resampling
# --------------------------------------------------------------------------- #
def test_systematic_resample_equals_jax():
    rng = np.random.default_rng(5)
    for i in range(40):
        K = int(rng.choice([4, 16, 64]))
        log_w = (3.0 * rng.standard_normal(K)).astype(np.float32)
        key = jax.random.PRNGKey(100 + i)
        want = np.asarray(jref._systematic_resample(key, jnp.asarray(log_w)))
        u0 = torch.as_tensor(np.asarray(jax.random.uniform(key, ())))
        got = tref._systematic_resample(u0, torch.as_tensor(log_w)).numpy()
        np.testing.assert_array_equal(got, want)


def _short_cdf_weights(K):
    """Seeded log-weights whose float32 cumulated softmax ends below 1.0."""
    rng = np.random.default_rng(17)
    for _ in range(1000):
        log_w = rng.standard_normal(K).astype(np.float32)
        if float(np.asarray(jnp.cumsum(jax.nn.softmax(jnp.asarray(log_w)))[-1])) < 1.0:
            return log_w
    raise AssertionError("no short cdf found")


@pytest.mark.parametrize("K", [4, 64])
def test_systematic_resample_out_of_range_index(K, monkeypatch):
    """JAX's largest uniform, 1 - 2^-24, puts the last point at
    (u0 + K - 1) / K = 1.0 in float32, above a cumulated softmax that ends
    below 1.0: the reference returns index K (out of range; jnp's
    take_along_axis then fills the particle with NaN), the port clamps it
    to the last particle."""
    log_w = _short_cdf_weights(K)
    u0 = np.float32(1.0 - 2.0 ** -24)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k:
                        jnp.full(shape, u0, jnp.float32))
    want = np.asarray(jref._systematic_resample(jax.random.PRNGKey(0), jnp.asarray(log_w)))
    assert want[-1] == K, "the reference returned %d" % want[-1]
    z = jnp.arange(K, dtype=jnp.float32)[None, :, None]
    taken = np.asarray(jnp.take_along_axis(z, jnp.asarray(want)[None, :, None], axis=1))
    assert np.isnan(taken[0, -1, 0])
    got = tref._systematic_resample(torch.as_tensor(u0), torch.as_tensor(log_w)).numpy()
    np.testing.assert_array_equal(got[:-1], want[:-1])
    assert got[-1] == K - 1


def test_systematic_resample_searchsorted_takes_the_left_side():
    """A point equal to a cdf entry goes to that entry's particle (``side
    left``, JAX's default and ``torch.searchsorted``'s ``right=False``)."""
    log_w = np.zeros(4, np.float32)  # cdf 0.25, 0.5, 0.75, 1.0: exact in float32
    want = np.asarray(jnp.searchsorted(jnp.cumsum(jax.nn.softmax(jnp.asarray(log_w))),
                                       (0.0 + jnp.arange(4)) / 4))
    got = tref._systematic_resample(torch.tensor(0.0), torch.as_tensor(log_w)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 0, 1, 2])
