"""One training step of the port against the JAX package on the CPU.

The same converted params, batch, mask and numpy draws ``u`` go through the
JAX loss body (``vihds_tpu.training.make_step_fns.loss_fn``) and the port's
``training.loss_fn``; the loss and every parameter gradient must agree:

* the online log-likelihood route (``solver: midpoint``, ``forward_logprob``
  with each step recomputed in the backward) against JAX's
  ``integrate_fold`` scan;
* the kernel route (``solver: pallas_midpoint``) against JAX through its
  Pallas kernel in interpret mode (forward ``_make_kernel``, backward
  ``_make_bwd_kernel``); on CPU tensors the port runs the kernels' plain
  versions, whose arithmetic is the kernels' (tests/test_torch_fused_bwd.py,
  tests/test_torch_prec.py).

Both routes for dr_constant_one, for dr_constant_precisions (the kernel
``dr_prec``, whose weight cotangent reaches the precision nets' leaves) and
for relay_constant_precisions and degrader_constant_precisions (kernels
``relay_prec`` and ``degrader_prec``), and the kernel route for
dr_constant_icml.

Tolerance: the loss (~1e2-1e6 nats, float32 sums of 86 x 4 log-likelihoods
in another order) to rtol 1e-6; each gradient leaf to 1e-4 of its own
largest entry (normwise; measured ~1e-6).  Also here: the optimizer against
optax with the JAX package's ``make_optimizer`` schedule, and the batch index
grids, bit for bit."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.conftest import make_args, spec
from vihds_tpu.config import Config as JConfig
from vihds_tpu.data.datasets import build_datasets as j_build
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu.training import batch_arrays
from vihds_tpu.training import build_epoch_stacks as j_build_epoch_stacks
from vihds_tpu.training import iwae_elbo as j_iwae_elbo
from vihds_tpu.training import iwae_elbo_terms as j_terms
from vihds_tpu.training import make_optimizer as j_make_optimizer
from vihds_tpu.training import prior_as_q as j_prior_as_q
from vihds_tpu.utils.attrdict import AttrDict as JAttrDict
from vihds_tpu.vae import VAE as JVAE
from vihds_tpu_torch import training as T
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.convert import params_from_jax
from vihds_tpu_torch.data.datasets import build_datasets as t_build
from vihds_tpu_torch.ops import fused_ode
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.utils.attrdict import AttrDict as TAttrDict
from vihds_tpu_torch.vae import VAE as TVAE

B, K = 3, 4


def _jax_loss_and_grads(spec_name, solver, u, mask, monkeypatch):
    args = make_args(spec(spec_name))
    jset = JConfig(args)
    jset.params.solver = solver
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    jmodel = JVAE(jset, jdata, jprog)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    host = jdata.train.dataset.select(np.arange(B))
    jbatch = batch_arrays(host)
    if solver.startswith("pallas_"):
        import vihds_tpu.ops.pallas_ode as pk

        ode = jmodel.ode_model
        kind = ode.pallas_kinds[1 if ode.precisions.dynamic else 0]
        name = fused_ode.KINDS[kind].simulate  # the JAX wrapper of the same name
        orig = getattr(pk, name)
        calls = []

        def spy(*a, **k):  # tests/test_pallas.py's route spy, in interpret mode
            calls.append(1)
            k["interpret"] = True
            return orig(*a, **k)

        monkeypatch.setattr(pk, name, spy)
    assert jmodel.ode_model.supports_fold() == (not solver.startswith("pallas_"))

    def loss(params):  # the body of make_step_fns.loss_fn
        if jmodel.ode_model.supports_fold():
            out = jmodel.forward_logprob(params, jbatch, jnp.asarray(u), checkpoint=True)
            log_p_obs = out.log_p_by_species.sum(axis=2)
            log_q = jprog.log_prob(out.q, out.theta)
            log_p = jprog.log_prob(j_prior_as_q(jprog), out.theta)
            terms = JAttrDict(log_w=log_p_obs + log_p - log_q)
        else:
            out = jmodel.forward(params, jbatch, jnp.asarray(u), checkpoint=True)
            terms = j_terms(jprog, out, jbatch, jmodel.use_laplace)
        return -j_iwae_elbo(terms, jnp.asarray(mask))

    value, grads = jax.value_and_grad(loss)(jparams)
    if solver.startswith("pallas_"):
        assert calls, "the JAX kernel route was not taken"
    return jparams, host, float(value), grads


@pytest.mark.parametrize(
    "spec_name,solver",
    [("dr_constant_one.yaml", "midpoint"), ("dr_constant_one.yaml", "pallas_midpoint"),
     ("dr_constant_icml.yaml", "pallas_midpoint"), ("dr_constant_precisions.yaml", "midpoint"),
     ("dr_constant_precisions.yaml", "pallas_midpoint"),
     ("relay_constant_precisions.yaml", "midpoint"),
     ("relay_constant_precisions.yaml", "pallas_midpoint"),
     ("degrader_constant_precisions.yaml", "midpoint"),
     ("degrader_constant_precisions.yaml", "pallas_midpoint")],
    ids=["fold-route", "kernel-route", "kernel-route-icml", "fold-route-precisions",
         "kernel-route-precisions", "fold-route-relay", "kernel-route-relay",
         "fold-route-degrader", "kernel-route-degrader"],
)
def test_one_step_loss_and_grads_match(spec_name, solver, monkeypatch):
    rng = np.random.default_rng(7)
    n_theta = JProgram(j_parse(JConfig(make_args(spec(spec_name))).params)).n_theta
    u = rng.standard_normal((B, K, n_theta)).astype(np.float32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)  # a padded row, as the last batch has
    jparams, host, j_loss, j_grads = _jax_loss_and_grads(spec_name, solver, u, mask, monkeypatch)

    targs = SimpleNamespace(yaml=spec(spec_name), seed=0, folds=4, split=1, heldout=None)
    tset = TConfig(targs)
    tset.params.solver = solver
    tdata = t_build(targs, tset)
    tprog = TProgram(t_parse(tset.params))
    tmodel = TVAE(tset, tdata, tprog)
    assert tmodel.ode_model.supports_fold() == (not solver.startswith("pallas_"))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    for leaf in T.param_leaves(tparams):
        leaf.requires_grad_(True)
    batch = T.batch_tensors(host, slice(None), torch.as_tensor(host.times), "cpu")
    loss = T.loss_fn(tmodel, tprog, tparams, batch, torch.as_tensor(mask), torch.as_tensor(u))
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=1e-6)
    leaves = jax.tree_util.tree_leaves_with_path(j_grads)
    assert len(leaves) == len(T.param_leaves(tparams))
    for path, g in leaves:
        t = tparams
        for p in path:
            t = t[p.key]
        ref = np.asarray(g)
        got = t.grad.numpy()
        assert np.isfinite(ref).all() and np.abs(ref).max() > 0
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=jax.tree_util.keystr(path))


def _schedule_settings(clip=None):
    p = dict(learning_rate=0.01, learning_boundaries=[1, 3], learning_gamma=0.2)
    if clip:
        p["grad_clip_norm"] = clip
    return JAttrDict(p), TAttrDict(p)


@pytest.mark.parametrize("clip", [None, 1.0], ids=["adam", "adam-clipped"])
def test_optimizer_matches_optax(clip):
    """Seven Adam steps on fixed gradients, two steps per epoch: the
    boundaries fall at optimizer steps 2 and 6, so steps 1-3 and 5-7 pin
    boundary-1, boundary and boundary+1.  Params are compared after every
    step (rtol 1e-6: float32 Adam, the same formula)."""
    jp, tp = _schedule_settings(clip)
    spe = 2
    rng = np.random.default_rng(0)
    init = {"a": rng.standard_normal(3).astype(np.float32),
            "b": {"c": rng.standard_normal((2, 2)).astype(np.float32)}}
    grads = [{"a": rng.standard_normal(3).astype(np.float32) * s,
              "b": {"c": rng.standard_normal((2, 2)).astype(np.float32) * s}}
             for s in (0.1, 3.0, 0.2, 5.0, 0.05, 2.0, 0.3)]

    tx = j_make_optimizer(jp, spe)
    j_params = jax.tree_util.tree_map(jnp.asarray, init)
    j_state = tx.init(j_params)
    t_params = {"a": torch.tensor(init["a"]), "b": {"c": torch.tensor(init["b"]["c"])}}
    for leaf in T.param_leaves(t_params):
        leaf.requires_grad_(True)
    opt = T.Optimizer(t_params, tp, spe)
    for n, g in enumerate(grads):
        updates, j_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.zero_grad()
        t_params["a"].grad = torch.tensor(g["a"])
        t_params["b"]["c"].grad = torch.tensor(g["b"]["c"])
        opt.step()
        for name, j_leaf, t_leaf in (("a", j_params["a"], t_params["a"]),
                                     ("c", j_params["b"]["c"], t_params["b"]["c"])):
            np.testing.assert_allclose(t_leaf.detach().numpy(), np.asarray(j_leaf), rtol=1e-6,
                                       atol=1e-7, err_msg="%s after step %d" % (name, n + 1))
    assert opt.count == len(grads)


def test_learning_rate_at_the_boundaries():
    """The schedule at boundary-1, boundary and boundary+1 (0-based optimizer
    step counts) equals the optax schedule ``make_optimizer`` builds."""
    jp, tp = _schedule_settings()
    spe = 7
    sched = optax.piecewise_constant_schedule(
        jp.learning_rate, {int(b) * spe: jp.learning_gamma for b in jp.learning_boundaries}
    )
    for b in tp.learning_boundaries:
        for count in (b * spe - 1, b * spe, b * spe + 1):
            assert T.learning_rate(tp, spe, count) == pytest.approx(float(sched(count)), rel=1e-6)
    assert T.learning_rate(tp, spe, 7) == pytest.approx(0.002)
    assert T.learning_rate(tp, spe, 6) == pytest.approx(0.01)


@pytest.mark.parametrize("seed,epoch,end_epoch,n_batch,n_train",
                         [(0, 1, 2, 36, 234), (3, 5, 5, 36, 216), (0, 1, 3, 4, 10)])
def test_epoch_index_grids_match(seed, epoch, end_epoch, n_batch, n_train):
    n_batches = -(-n_train // n_batch)
    j = j_build_epoch_stacks(seed, epoch, end_epoch, n_batch, n_batches, n_train)
    t = T.build_epoch_stacks(seed, epoch, end_epoch, n_batch, n_batches, n_train)
    for k in ("idx", "mask"):
        assert j[k].dtype == t[k].dtype
        np.testing.assert_array_equal(j[k], t[k])
