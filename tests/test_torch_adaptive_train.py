"""Training through the port's adaptive solvers and continuous adjoint on
the CPU, against the JAX package.

* One training step of dr_constant_one (3 series x 4 draws, one padded
  row) under each adaptive solver and under ``adjoint_solver: true`` with
  midpoint: the same converted params, batch, mask and numpy draws ``u``
  through the JAX loss body (the trajectory route: ``supports_fold`` is
  False in both packages) and the port's ``training.loss_fn``.  The loss to
  rtol 1e-5, each gradient leaf to 1e-4 of its own largest entry (the
  adaptive forward sums its stages in another order, and the adjoint's
  backward re-integrates from the grid states either package stored).
* One DReG step under dopri5 against ``vihds_tpu.training.dreg_value_and_grad``
  at the same tolerances.
* ``run_xval.main`` on a dopri5 spec for one epoch, to finite ELBOs and the
  xval artifacts.
* Every shipped spec's model under dopri5: a finite loss and a gradient in
  every decoder leaf.
"""

import glob
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.conftest import make_args, spec
from vihds_tpu.config import Config as JConfig
from vihds_tpu.data.datasets import build_datasets as j_build
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu.training import batch_arrays
from vihds_tpu.training import dreg_value_and_grad as j_dreg
from vihds_tpu.training import iwae_elbo as j_iwae_elbo
from vihds_tpu.training import iwae_elbo_terms as j_terms
from vihds_tpu.vae import VAE as JVAE
from vihds_tpu_torch import run_xval
from vihds_tpu_torch import training as T
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.convert import params_from_jax
from vihds_tpu_torch.data.datasets import build_datasets as t_build
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.vae import VAE as TVAE

B, K = 3, 4
MASK = np.array([1.0, 1.0, 0.0], np.float32)  # a padded row, as the last batch has
SPEC = "dr_constant_one.yaml"
CASES = [("dopri5", False), ("dopri8", False), ("bosh3", False), ("adaptive_heun", False),
         ("midpoint", True)]
IDS = ["dopri5", "dopri8", "bosh3", "adaptive_heun", "adjoint-midpoint"]


def _jax(solver, adjoint):
    args = make_args(spec(SPEC))
    jset = JConfig(args)
    jset.params.solver = solver
    jset.params.adjoint_solver = adjoint
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    jmodel = JVAE(jset, jdata, jprog)
    assert not jmodel.ode_model.supports_fold()
    return jmodel, jprog, jmodel.init_params(jax.random.PRNGKey(0)), jdata.train.dataset.select(
        np.arange(B))


def _port(solver, adjoint, jparams, host):
    targs = SimpleNamespace(yaml=spec(SPEC), seed=0, folds=4, split=1, heldout=None)
    tset = TConfig(targs)
    tset.params.solver = solver
    tset.params.adjoint_solver = adjoint
    tprog = TProgram(t_parse(tset.params))
    tmodel = TVAE(tset, t_build(targs, tset), tprog)
    assert not tmodel.ode_model.supports_fold()
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    for leaf in T.param_leaves(tparams):
        leaf.requires_grad_(True)
    batch = T.batch_tensors(host, slice(None), torch.as_tensor(host.times), "cpu")
    return tmodel, tprog, tparams, batch


def _compare(tparams, by_leaf, j_grads):
    leaves = jax.tree_util.tree_leaves_with_path(j_grads)
    assert len(leaves) == len(T.param_leaves(tparams))
    for path, g in leaves:
        t = tparams
        for p in path:
            t = t[p.key]
        ref = np.asarray(g)
        assert np.isfinite(ref).all() and np.abs(ref).max() > 0
        np.testing.assert_allclose(by_leaf(t), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=jax.tree_util.keystr(path))


def _u(jprog, seed=7):
    return np.random.default_rng(seed).standard_normal((B, K, jprog.n_theta)).astype(np.float32)


@pytest.mark.parametrize("solver,adjoint", CASES, ids=IDS)
def test_one_step_loss_and_grads_match(solver, adjoint):
    jmodel, jprog, jparams, host = _jax(solver, adjoint)
    u = _u(jprog)
    jbatch = batch_arrays(host)

    def loss(params):  # the trajectory route of make_step_fns.loss_fn
        out = jmodel.forward(params, jbatch, jnp.asarray(u), checkpoint=True)
        return -j_iwae_elbo(j_terms(jprog, out, jbatch, jmodel.use_laplace), jnp.asarray(MASK))

    j_loss, j_grads = jax.value_and_grad(loss)(jparams)
    tmodel, tprog, tparams, batch = _port(solver, adjoint, jparams, host)
    loss = T.loss_fn(tmodel, tprog, tparams, batch, torch.as_tensor(MASK), torch.as_tensor(u))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    _compare(tparams, lambda t: t.grad.numpy(), j_grads)


def test_dreg_step_matches_the_jax_package(monkeypatch):
    jmodel, jprog, jparams, host = _jax("dopri5", False)
    u = _u(jprog)
    monkeypatch.setattr(jmodel, "sample_u", lambda key, n_batch, n_samples: jnp.asarray(u))
    j_loss, j_grads = j_dreg(jmodel, jprog, K, jmodel.use_laplace)(
        jparams, batch_arrays(host), jnp.asarray(MASK), jax.random.PRNGKey(1))
    tmodel, tprog, tparams, batch = _port("dopri5", False, jparams, host)
    loss, grads = T.dreg_value_and_grad(tmodel, tprog, tparams, batch, torch.as_tensor(MASK),
                                        torch.as_tensor(u))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    by_leaf = {id(leaf): g for part in ("enc", "dec")
               for leaf, g in zip(T.param_leaves(tparams[part]), grads[part])}
    _compare(tparams, lambda t: by_leaf[id(t)].numpy(), j_grads)


def test_run_xval_trains_through_dopri5(tmp_path, monkeypatch):
    """The CLI's entry point on a spec that names ``solver: dopri5``: one
    epoch, evaluated, to finite ELBOs and the xval artifacts."""
    monkeypatch.setenv("INFERENCE_RESULTS_DIR", str(tmp_path / "results"))
    with open(spec(SPEC)) as f:
        doc = yaml.safe_load(f)
    doc["params"]["solver"] = "dopri5"
    path = tmp_path / "dr_constant_one_dopri5.yaml"
    path.write_text(yaml.safe_dump(doc))
    run_xval.main([str(path), "--experiment", "dopri5", "--epochs", "1", "--test_epoch", "1",
                   "--train_samples", "4", "--test_samples", "4", "--seed", "0",
                   "--plot_epoch", "0"], device="cpu")
    (run,) = os.listdir(tmp_path / "results")
    names = os.listdir(tmp_path / "results" / run)
    assert "completed.txt" in names
    assert len([n for n in names if n.startswith("xval_")]) == 16
    elbo = np.load(tmp_path / "results" / run / "xval_elbo.npy", allow_pickle=True)
    assert np.isfinite(np.asarray(elbo, dtype=np.float64)).all()


# one spec per model: debug_precisions.yaml has no init_prec_* sites (in
# either package), and dr_constant_icml stands for dr_constant_one and the
# unmerged spec
ZOO = sorted(os.path.basename(p) for p in glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "specs", "*.yaml"))
    if not p.endswith(("debug_precisions.yaml", "dr_constant_one.yaml", "_unmerged.yaml")))


@pytest.mark.parametrize("spec_name", ZOO)
def test_every_spec_trains_through_dopri5(spec_name):
    """Each shipped spec's model (the 14 models they name, overrides of
    ``simulate`` and ``make_rhs`` included) under ``solver: dopri5``: one
    loss on 2 series x 2 draws, finite, and a finite, non-zero gradient in
    every decoder leaf (the precision nets, the device conditioners, the
    black-box nets): the adjoint hands gradient to every tensor its
    right-hand side closes over."""
    targs = SimpleNamespace(yaml=spec(spec_name), seed=0, folds=4, split=1, heldout=None)
    tset = TConfig(targs)
    tset.params.solver = "dopri5"
    tprog = TProgram(t_parse(tset.params))
    data = t_build(targs, tset)
    tmodel = TVAE(tset, data, tprog)
    params = tmodel.init_params(torch.Generator().manual_seed(0), device="cpu")
    for leaf in T.param_leaves(params):
        leaf.requires_grad_(True)
    host = data.train.dataset.select(np.arange(2))
    batch = T.batch_tensors(host, slice(None), torch.as_tensor(host.times), "cpu")
    u = torch.randn((2, 2, tprog.n_theta), generator=torch.Generator().manual_seed(1))
    loss = T.loss_fn(tmodel, tprog, params, batch, torch.ones(2), u)
    loss.backward()
    assert torch.isfinite(loss)
    for leaf in T.param_leaves(params):
        assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())
    for leaf in T.param_leaves(params["dec"]):
        assert float(leaf.grad.abs().max()) > 0
