"""The port's refinement targets on the ODE (``vihds_tpu_torch.refine``'s
``make_log_lik`` and ``make_log_joint``) against the JAX
package's on the CPU: the value and the z-gradient of the log-joint through
the decoder, for dr_constant_one (the generic midpoint solver's fold route)
and dr_constant_precisions (``expand_precisions``, the learned precisions),
on 3 series x 4 chains drawn about the prior.
No sampler runs here: tests/test_torch_refine.py holds the samplers.

Tolerances: values rtol 1e-5; the gradient to 1e-4 of its largest entry.
JAX's data term is read as its log-joint less the prior term.
The port's kernel route (``solver: pallas_midpoint``, the fused kernels'
plain versions on CPU tensors) is held against its fold route at the same
limits.  The JAX runs are shared through a module fixture."""

import jax
import numpy as np
import pytest
import torch

from tests.conftest import make_args, spec
from tests.test_torch_refine import _torch_setup
from vihds_tpu import refine as jref
from vihds_tpu.config import Config as JConfig
from vihds_tpu.data.datasets import build_datasets as j_build
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu.training import batch_arrays
from vihds_tpu.vae import VAE as JVAE
from vihds_tpu_torch import refine as tref
from vihds_tpu_torch.ops import fused_ode

N_SERIES, N_CHAINS = 3, 4
SPECS = ["dr_constant_one.yaml", "dr_constant_precisions.yaml"]


def _run(spec_name):
    args = make_args(spec(spec_name))
    jset = JConfig(args)
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    jmodel = JVAE(jset, jdata, jprog)
    jparams = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    host = jdata.train.dataset.select(np.arange(N_SERIES))
    jbatch = batch_arrays(host)
    # z about the prior, 3 series x 4 chains (the samplers' initial draw from
    # q is held in tests/test_torch_refine.py)
    rng = np.random.default_rng(4)
    sd = 1.0 / np.sqrt(jprog.prior_prec)
    z = (jprog.prior_mu + 0.5 * sd * rng.standard_normal((N_SERIES, N_CHAINS, jprog.n_theta))
         ).astype(np.float32)

    def target(z_):
        log_joint = jref.make_log_joint(jmodel, jprog, jparams, jbatch)(z_)
        return log_joint.sum(), log_joint

    (_, log_joint), grad = jax.jit(jax.value_and_grad(target, has_aux=True))(z)
    # the data term: the log-joint less its prior term (one ODE solve, not two)
    log_lik = log_joint - (jref.log_prior_z_cols(jprog, z) * jref._sampled_mask(jprog)).sum(-1)
    jax_out = {k: np.asarray(v) for k, v in dict(log_lik=log_lik, log_joint=log_joint,
                                                 grad=grad).items()}

    tprog, tmodel, tparams, tbatch = _torch_setup(spec(spec_name), jparams, host)
    zt = torch.as_tensor(z)
    port = _port_target(tmodel, tprog, tparams, tbatch, zt)
    solver = tmodel.ode_model.solver
    tmodel.ode_model.solver = "pallas_midpoint"
    try:
        kernel = _port_target(tmodel, tprog, tparams, tbatch, zt)
    finally:
        tmodel.ode_model.solver = solver
    return (jax_out, {k: v.detach().numpy() for k, v in port.items()},
            {k: v.detach().numpy() for k, v in kernel.items()}, z)


def _port_target(tmodel, tprog, tparams, tbatch, z):
    log_joint = tref.make_log_joint(tmodel, tprog, tparams, tbatch)
    return dict(log_lik=tref.make_log_lik(tmodel, tprog, tparams, tbatch)(
        tref.constrain_z(tprog, z)), log_joint=log_joint(z), grad=tref._grad(log_joint)(z))


@pytest.fixture(scope="module")
def runs():
    return {name: _run(name) for name in SPECS}


@pytest.mark.parametrize("spec_name", SPECS)
@pytest.mark.parametrize("quantity", ["log_lik", "log_joint", "grad"])
def test_target_equals_jax(runs, spec_name, quantity):
    want, got, _, _ = runs[spec_name]
    want, got = want[quantity], got[quantity]
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(want).all()
    if quantity == "grad":
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("spec_name", SPECS)
def test_kernel_route_equals_the_fold_route(runs, spec_name):
    """Under ``solver: pallas_midpoint`` (the fused kernels' plain versions
    here) the target and its z-gradient equal the fold route's."""
    _, fold, kernel, _ = runs[spec_name]
    np.testing.assert_allclose(kernel["log_joint"], fold["log_joint"], rtol=1e-5)
    np.testing.assert_allclose(kernel["grad"], fold["grad"], rtol=0,
                               atol=1e-4 * np.abs(fold["grad"]).max())


def test_the_kernel_route_runs_the_kind(runs, monkeypatch):
    """The kernel route of the target goes through the kind's fused wrapper
    (``fused_ode.simulate_kind``), forward and backward, on CPU tensors."""
    seen = []
    orig = fused_ode._plain_bwd

    def spy(kind, *a):
        seen.append(kind)
        return orig(kind, *a)

    monkeypatch.setattr(fused_ode, "_plain_bwd", spy)
    args = make_args(spec("dr_constant_one.yaml"))
    jset = JConfig(args)
    jdata = j_build(args, jset)
    jmodel = JVAE(jset, jdata, JProgram(j_parse(jset.params)))
    host = jdata.train.dataset.select(np.arange(N_SERIES))
    tprog, tmodel, tparams, tbatch = _torch_setup(spec("dr_constant_one.yaml"),
                                                  jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)), host)
    tmodel.ode_model.solver = "pallas_midpoint"
    z = torch.as_tensor(runs["dr_constant_one.yaml"][3])
    tref._grad(tref.make_log_joint(tmodel, tprog, tparams, tbatch))(z)
    assert seen == ["dr"]
