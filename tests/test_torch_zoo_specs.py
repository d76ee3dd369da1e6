"""Every shipped spec on the port's CPU path, and the ``dr_growthrate``
route, against the JAX package:

* one training loss of every runnable spec in ``specs/`` (its own solver,
  B = min(8, n_train), K=5; the first file's rows on ``merge: false`` data)
  has finite gradients in every param leaf;
* ``debug_precisions.yaml`` names ``dr_constant_precisions`` but defines
  none of its ``init_prec_*`` sites: both packages stop at the same missing
  site;
* under ``solver: pallas_midpoint`` the JAX package sends ``DR_Growthrate``
  through the ``dr`` kernel (its inherited ``pallas_kinds``), whose
  right-hand side has no growth-coupled capacity ``es``; the port takes its
  generic solver and equals it bit for bit.
"""

import glob
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_args, spec
from tests.test_torch_zoo import _pair
from vihds_tpu.config import Config as JConfig
from vihds_tpu.data.datasets import build_datasets as j_build
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu.training import batch_arrays
from vihds_tpu.vae import VAE as JVAE
from vihds_tpu_torch import training as T
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.data.datasets import build_datasets as t_build
from vihds_tpu_torch.ops import fused_ode
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.vae import VAE as TVAE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_SPECS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "specs", "*.yaml")))
#: names ``dr_constant_precisions`` but defines none of its ``init_prec_*``
#: sites: neither package can run it (ROADMAP queue 3)
BROKEN_SPEC = "debug_precisions.yaml"
K = 4


@pytest.mark.parametrize("spec_name", [s for s in ALL_SPECS if s != BROKEN_SPEC])
def test_no_nan_gradients(spec_name):
    """One training loss (the spec's own solver, B = min(8, n_train), K=5)
    and its gradient are finite for every runnable spec."""
    args = SimpleNamespace(yaml=spec(spec_name), seed=0, folds=4, split=1, heldout=None)
    settings = TConfig(args)
    data = t_build(args, settings)
    program = TProgram(t_parse(settings.params))
    model = TVAE(settings, data, program)
    training = T.Training(settings, data, program, model, device="cpu")
    params, _, gen = training.init_state("cpu")
    host = training.train_groups[0][1] if training.multi else data.train.batch()
    n = min(8, host.observations.shape[0])
    batch = T.batch_tensors(host, np.arange(n), torch.as_tensor(host.times), "cpu")
    u = model.sample_u(gen, n, 5, "cpu")
    loss = T.loss_fn(model, program, params, batch, torch.ones(n), u)
    loss.backward()
    assert torch.isfinite(loss)
    for leaf in T.param_leaves(params):
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()


def test_the_broken_spec_fails_alike_in_both_packages():
    """``debug_precisions.yaml`` builds, but its model's initial state reads
    ``init_prec_x``, which the spec never defines: both packages stop there."""
    args = make_args(spec(BROKEN_SPEC))
    jset = JConfig(args)
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    jmodel = JVAE(jset, jdata, jprog)
    assert "init_prec_x" not in jprog.names
    u = jnp.zeros((1, 2, jprog.n_theta), jnp.float32)
    with pytest.raises(KeyError, match="init_prec_x"):
        jmodel.forward(jmodel.init_params(jax.random.PRNGKey(0)),
                       batch_arrays(jdata.train.dataset.select(np.arange(1))), u)
    targs = SimpleNamespace(yaml=spec(BROKEN_SPEC), seed=0, folds=4, split=1, heldout=None)
    tset = TConfig(targs)
    tdata = t_build(targs, tset)
    tprog = TProgram(t_parse(tset.params))
    tmodel = TVAE(tset, tdata, tprog)
    host = tdata.train.batch()
    batch = T.batch_tensors(host, np.arange(1), torch.as_tensor(host.times), "cpu")
    with pytest.raises(KeyError, match="init_prec_x"):
        tmodel.forward(tmodel.init_params(torch.Generator().manual_seed(0), device="cpu"), batch,
                       torch.zeros(1, 2, tprog.n_theta))


def test_dr_growthrate_takes_the_generic_solver_under_pallas(monkeypatch):
    """Under ``solver: pallas_midpoint`` the JAX package routes
    ``DR_Growthrate`` through the ``dr`` kernel (its inherited
    ``pallas_kinds``), whose right-hand side has no ``es``: its trajectory
    leaves its own generic solver's.  The port launches no fused kind and
    equals its generic midpoint solver bit for bit, and the JAX package's
    generic solver to rtol 2e-5."""
    import vihds_tpu.ops.pallas_ode as pk

    p = _pair("dr_growthrate", solver="pallas_midpoint")
    j_kinds, t_kinds = [], []
    orig = pk.simulate_kind

    def j_spy(kind, *a, **k):
        j_kinds.append(kind)
        k["interpret"] = True
        return orig(kind, *a, **k)

    monkeypatch.setattr(pk, "simulate_kind", j_spy)
    monkeypatch.setattr(fused_ode, "simulate_kind", lambda kind, *a, **k: t_kinds.append(kind))

    jbatch = batch_arrays(p.host)
    theta = p.jmodel.forward(p.jparams, jbatch, jnp.asarray(p.u)).theta_cond
    j_kinds.clear()
    jode, tode = p.jmodel.ode_model, p.tmodel.ode_model
    args = (jbatch.times, jbatch.inputs, jbatch.dev_1hot, K)
    j_kernel = np.asarray(jode.simulate(p.jparams["dec"], theta, *args))
    assert j_kinds == ["dr"]
    jode.solver = "midpoint"
    j_generic = np.asarray(jode.simulate(p.jparams["dec"], theta, *args))
    assert np.abs(j_kernel - j_generic).max() > 1e-3 * np.abs(j_generic).max()

    theta_t = {k: torch.tensor(np.asarray(v)) for k, v in theta.items()}
    tbatch = T.batch_tensors(p.host, slice(None), torch.as_tensor(p.host.times), "cpu")
    targs = (tbatch.times, tbatch.inputs, tbatch.dev_1hot, K)
    assert tode.solver == "pallas_midpoint" and tode.pallas_kinds is None
    t_pallas = tode.simulate(p.tparams["dec"], theta_t, *targs)
    tode.solver = "midpoint"
    t_generic = tode.simulate(p.tparams["dec"], theta_t, *targs)
    assert t_kinds == []
    torch.testing.assert_close(t_pallas, t_generic, rtol=0, atol=0)
    np.testing.assert_allclose(t_pallas.numpy(), j_generic, rtol=2e-5,
                               atol=1e-6 * np.abs(j_generic).max())
