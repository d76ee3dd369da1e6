"""The rest of the model zoo in the port against the JAX package on the CPU:
``debug_constant``, ``auto_constant(_precisions)``,
``prpr_constant(_precisions)``, ``inducer_constant(_precisions)`` and
``dr_growthrate``.

For each model, at the same theta (the JAX package's conditioned theta of
one forward pass on converted params and the same draws ``u``):
``initialize_state``, the right-hand side at seeded states and times, and
``observe`` to rtol 2e-5; and the log-weights of a small batch (the eval
forward on the spec's own solver, then the IWAE terms) to rtol 1e-5.  Also:
the registry holds the JAX package's 17 keys, and ``convert.params_from_jax``
covers every new model's params leaf for leaf (the precision nets of the
``_precisions`` variants too).  Every spec's gradients and the
``dr_growthrate`` route: tests/test_torch_zoo_specs.py.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vihds_tpu.models as j_models
from tests.conftest import make_args, spec
from vihds_tpu.config import Config as JConfig
from vihds_tpu.data.datasets import build_datasets as j_build
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu.training import batch_arrays
from vihds_tpu.training import iwae_elbo_terms as j_terms
from vihds_tpu.vae import VAE as JVAE
from vihds_tpu_torch import models as t_models
from vihds_tpu_torch import training as T
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.convert import params_from_jax
from vihds_tpu_torch.data.datasets import build_datasets as t_build
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.vae import VAE as TVAE

#: model -> the spec whose settings build it (``inducer_constant`` has no
#: spec of its own; it is built from its ``_precisions`` variant's, with the
#: four constant precisions added)
ZOO = {
    "debug_constant": "debug.yaml",
    "auto_constant": "auto_constant.yaml",
    "auto_constant_precisions": "auto_constant_precisions.yaml",
    "prpr_constant": "prpr_constant.yaml",
    "prpr_constant_precisions": "prpr_constant_precisions.yaml",
    "inducer_constant": "inducer_constant_precisions.yaml",
    "inducer_constant_precisions": "inducer_constant_precisions.yaml",
    "dr_growthrate": "dr_growthrate_xval.yaml",
}
B, K = 3, 4


def _pair(model_name, solver=None):
    """Both packages' settings, program, VAE and (converted) params."""
    spec_name = ZOO[model_name]
    args = make_args(spec(spec_name))
    jset = JConfig(args)
    jset.model = model_name
    targs = SimpleNamespace(yaml=spec(spec_name), seed=0, folds=4, split=1, heldout=None)
    tset = TConfig(targs)
    tset.model = model_name
    if solver:
        jset.params.solver = tset.params.solver = solver
    if model_name == "inducer_constant":
        # its constant precisions, as auto_constant.yaml defines them
        for s in (jset, tset):
            site = s.params["global"]["drfp"]
            s.params["global"].update(
                (name, type(site)(distribution="LogNormal", mu=8.0, sigma=2.0))
                for name in ("prec_x", "prec_rfp", "prec_yfp", "prec_cfp"))
    jdata, tdata = j_build(args, jset), t_build(targs, tset)
    jprog, tprog = JProgram(j_parse(jset.params)), TProgram(t_parse(tset.params))
    jmodel, tmodel = JVAE(jset, jdata, jprog), TVAE(tset, tdata, tprog)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    host = jdata.train.dataset.select(np.arange(B))
    u = np.random.default_rng(3).standard_normal((B, K, jprog.n_theta)).astype(np.float32)
    return SimpleNamespace(jprog=jprog, tprog=tprog, jmodel=jmodel, tmodel=tmodel,
                           jparams=jparams, tparams=tparams, host=host, u=u)


@pytest.fixture(scope="module", params=sorted(ZOO))
def pair(request):
    p = _pair(request.param)
    p.name = request.param
    p.jbatch = batch_arrays(p.host)

    def forward(params, batch, u):
        out = p.jmodel.forward(params, batch, u, eval_mode=True)
        return out, j_terms(p.jprog, out, batch, p.jmodel.use_laplace)

    p.jout, p.jterms = jax.jit(forward)(p.jparams, p.jbatch, jnp.asarray(p.u))
    p.theta_np = {k: np.asarray(v) for k, v in p.jout.theta_cond.items()}
    p.theta_t = {k: torch.tensor(v) for k, v in p.theta_np.items()}
    p.tbatch = T.batch_tensors(p.host, slice(None), torch.as_tensor(p.host.times), "cpu")
    return p


def test_registry_holds_the_jax_packages_models():
    assert set(t_models.LOOKUP) == set(j_models.LOOKUP)
    assert len(t_models.LOOKUP) == 17


def test_initial_state_matches_jax(pair):
    j = pair.jmodel.ode_model.initialize_state(pair.jparams["dec"], pair.theta_np,
                                               pair.jbatch.inputs, B, K)
    t = pair.tmodel.ode_model.initialize_state(pair.tparams["dec"], pair.theta_t,
                                               pair.tbatch.inputs, B, K)
    assert t.shape == j.shape
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5)


def test_rhs_matches_jax(pair):
    jode, tode = pair.jmodel.ode_model, pair.tmodel.ode_model
    n_states = tode.n_species + (4 if tode.precisions.dynamic else 0)
    rng = np.random.default_rng(5)
    jrhs = jode.make_rhs(pair.jparams["dec"], pair.theta_np, pair.jbatch.inputs,
                         pair.jbatch.dev_1hot)
    trhs = tode.make_rhs(pair.tparams["dec"], pair.theta_t, pair.tbatch.inputs,
                         pair.tbatch.dev_1hot)
    for t in (0.0, 1.3, 7.9):
        state = rng.uniform(0.05, 2.0, (B, K, n_states)).astype(np.float32)
        j = np.asarray(jrhs(jnp.float32(t), jnp.asarray(state)))
        got = trhs(torch.tensor(t), torch.as_tensor(state)).numpy()
        assert got.shape == j.shape == (B, K, n_states)
        assert np.isfinite(j).all()
        np.testing.assert_allclose(got, j, rtol=2e-5, atol=1e-6 * np.abs(j).max(),
                                   err_msg="t=%g" % t)


def test_observe_matches_jax(pair):
    S = pair.tmodel.ode_model.n_species
    x = np.random.default_rng(9).uniform(0.0, 2.0, (B, K, S, 7)).astype(np.float32)
    j = pair.jmodel.ode_model.observe(jnp.asarray(x), pair.theta_np)
    t = pair.tmodel.ode_model.observe(torch.as_tensor(x), pair.theta_t)
    assert t.shape == j.shape == (B, K, 4, 7)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5)


def test_log_prob_matches_jax(pair):
    """The eval forward on the spec's solver and its IWAE terms."""
    jt = pair.jterms
    with torch.no_grad():
        tout = pair.tmodel.forward(pair.tparams, pair.tbatch, torch.as_tensor(pair.u),
                                   eval_mode=True)
        tt = T.iwae_elbo_terms(pair.tprog, tout, pair.tbatch, pair.tmodel.use_laplace)
    for name, want in pair.theta_np.items():
        np.testing.assert_allclose(tout.theta_cond[name].numpy(), want, rtol=1e-6, err_msg=name)
    for name in ("log_p_obs", "log_q", "log_p", "log_w"):
        assert np.isfinite(np.asarray(jt[name])).all(), name
        np.testing.assert_allclose(tt[name].numpy(), np.asarray(jt[name]), rtol=1e-5,
                                   err_msg=name)


def test_params_from_jax_covers_every_leaf(pair):
    """The converted JAX params have the port's own tree: the same keys and
    shapes as ``VAE.init_params``, the precision nets included."""
    own = pair.tmodel.init_params(torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert shapes(pair.tparams) == shapes(own)
    if pair.name.endswith("_precisions"):
        assert set(pair.tparams["dec"]["precisions"]) == {"prod", "degr"}
