"""The port's DReG estimator (``training.dreg_value_and_grad``) on the CPU.

* Parity: the same converted params, batch, mask and numpy draws ``u`` go
  through ``vihds_tpu.training.dreg_value_and_grad`` (its ``sample_u``
  handed ``u``) and the port's; the loss must agree to rtol 1e-6 and each
  gradient leaf to 1e-4 of its own largest entry (the one-step rule of
  tests/test_torch_train.py).  Cases: dr_constant_one on the fold route
  (``midpoint``) and the kernel route (``pallas_midpoint``),
  dr_constant_precisions and dr_blackbox_icml on the kernel route; JAX's
  kernel route runs its Pallas kernels in interpret mode (the route spy of
  tests/test_torch_train.py), the port's the kernels' plain versions.
* Properties: the decoder's gradient is the standard IWAE gradient and the
  encoder's differs from it; each pull runs the fused backward once where it
  reaches the ODE (dr_constant_one's decoder has no leaves, so one pull;
  dr_constant_icml's device conditioners, the precision nets and the
  black-box nets make two); a second pull on one saved context gives what a
  fresh graph gives, bit for bit, on both fused autograd Functions; and
  ``run_xval.main --dreg`` trains to finite ELBOs.
"""

import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_args, spec
from vihds_tpu.config import Config as JConfig
from vihds_tpu.data.datasets import build_datasets as j_build
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu.training import batch_arrays
from vihds_tpu.training import dreg_value_and_grad as j_dreg
from vihds_tpu.vae import VAE as JVAE
from vihds_tpu_torch import run_xval
from vihds_tpu_torch import training as T
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.convert import params_from_jax
from vihds_tpu_torch.data.datasets import build_datasets as t_build
from vihds_tpu_torch.ops import fused_blackbox, fused_ode
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.vae import VAE as TVAE

B, K = 3, 4
MASK = np.array([1.0, 1.0, 0.0], np.float32)  # a padded row, as the last batch has


def _jax_route_spy(jmodel, monkeypatch):
    """Run the JAX model's Pallas kernel in interpret mode; returns the list
    its calls append to."""
    calls = []
    if jmodel.ode_model.pallas_kinds is None:  # dr_blackbox: its own kernel module
        import vihds_tpu.ops.pallas_blackbox as module

        name = "blackbox_simulate"
    else:
        import vihds_tpu.ops.pallas_ode as module

        ode = jmodel.ode_model
        name = fused_ode.KINDS[ode.pallas_kinds[1 if ode.precisions.dynamic else 0]].simulate
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(1)
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _port(spec_name, solver):
    targs = SimpleNamespace(yaml=spec(spec_name), seed=0, folds=4, split=1, heldout=None)
    tset = TConfig(targs)
    tset.params.solver = solver
    tdata = t_build(targs, tset)
    tprog = TProgram(t_parse(tset.params))
    return tdata, tprog, TVAE(tset, tdata, tprog)


def _port_inputs(spec_name, solver, seed=7):
    """(model, program, params with grads on, batch, mask, u) for B rows of
    the train split at K draws, the params from the CPU generator."""
    tdata, tprog, tmodel = _port(spec_name, solver)
    params = tmodel.init_params(torch.Generator().manual_seed(0), device="cpu")
    for leaf in T.param_leaves(params):
        leaf.requires_grad_(True)
    host = tdata.train.dataset.select(np.arange(B))
    batch = T.batch_tensors(host, slice(None), torch.as_tensor(host.times), "cpu")
    u = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (B, K, tprog.n_theta)).astype(np.float32))
    return tmodel, tprog, params, batch, torch.as_tensor(MASK), u


@pytest.mark.parametrize(
    "spec_name,solver",
    [("dr_constant_one.yaml", "midpoint"), ("dr_constant_one.yaml", "pallas_midpoint"),
     ("dr_constant_precisions.yaml", "pallas_midpoint"),
     ("dr_blackbox_icml.yaml", "pallas_midpoint")],
    ids=["fold-route", "kernel-route", "kernel-route-precisions", "kernel-route-blackbox"],
)
def test_dreg_matches_the_jax_package(spec_name, solver, monkeypatch):
    args = make_args(spec(spec_name))
    jset = JConfig(args)
    jset.params.solver = solver
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    jmodel = JVAE(jset, jdata, jprog)
    assert jmodel.ode_model.supports_fold() == (solver == "midpoint")
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    host = jdata.train.dataset.select(np.arange(B))
    u = np.random.default_rng(7).standard_normal((B, K, jprog.n_theta)).astype(np.float32)
    calls = _jax_route_spy(jmodel, monkeypatch) if solver != "midpoint" else None
    monkeypatch.setattr(jmodel, "sample_u", lambda key, n_batch, n_samples: jnp.asarray(u))
    j_loss, j_grads = jax.jit(j_dreg(jmodel, jprog, K, jmodel.use_laplace))(
        jparams, batch_arrays(host), jnp.asarray(MASK), jax.random.PRNGKey(1))
    if calls is not None:
        assert calls, "the JAX kernel route was not taken"

    _, tprog, tmodel = _port(spec_name, solver)
    assert tmodel.ode_model.supports_fold() == (solver == "midpoint")
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    for leaf in T.param_leaves(tparams):
        leaf.requires_grad_(True)
    batch = T.batch_tensors(host, slice(None), torch.as_tensor(host.times), "cpu")
    loss, grads = T.dreg_value_and_grad(tmodel, tprog, tparams, batch, torch.as_tensor(MASK),
                                        torch.as_tensor(u))

    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
    by_leaf = {id(leaf): g for part in ("enc", "dec")
               for leaf, g in zip(T.param_leaves(tparams[part]), grads[part])}
    leaves = jax.tree_util.tree_leaves_with_path(j_grads)
    assert len(leaves) == len(by_leaf) == len(T.param_leaves(tparams))
    for path, g in leaves:
        t = tparams
        for p in path:
            t = t[p.key]
        ref = np.asarray(g)
        assert np.isfinite(ref).all() and np.abs(ref).max() > 0
        np.testing.assert_allclose(by_leaf[id(t)].numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("solver", ["midpoint", "pallas_midpoint"])
def test_decoder_takes_the_standard_gradient_and_the_encoder_the_dreg_one(solver):
    """dr_constant_precisions, whose decoder holds the device conditioners
    and the precision nets: DReG's decoder gradient is ``loss_fn``'s, its
    encoder gradient is not, and both losses are the same number."""
    model, prog, params, batch, mask, u = _port_inputs("dr_constant_precisions.yaml", solver)
    loss, grads = T.dreg_value_and_grad(model, prog, params, batch, mask, u)
    std = T.loss_fn(model, prog, params, batch, mask, u)
    std.backward()
    torch.testing.assert_close(loss, std.detach(), rtol=1e-6, atol=0)
    dec = T.param_leaves(params["dec"])
    assert len(dec) == len(grads["dec"]) > 0
    for leaf, g in zip(dec, grads["dec"]):
        torch.testing.assert_close(g, leaf.grad, rtol=1e-5, atol=1e-6 * float(g.abs().max()))
    enc = T.param_leaves(params["enc"])
    diff = max(float((g - leaf.grad).abs().max() / leaf.grad.abs().max())
               for leaf, g in zip(enc, grads["enc"]))
    assert diff > 1e-2
    assert all(bool(torch.isfinite(g).all()) for g in grads["enc"] + grads["dec"])


@pytest.mark.parametrize(
    "spec_name,backward,pulls",
    [("dr_constant_one.yaml", "fused_ode", 1), ("dr_constant_icml.yaml", "fused_ode", 2),
     ("dr_constant_precisions.yaml", "fused_ode", 2),
     ("dr_blackbox_icml.yaml", "fused_blackbox", 2)],
    ids=["no-decoder-leaves", "device-conditioners", "precision-nets", "blackbox-nets"],
)
def test_each_pull_runs_the_fused_backward_once(spec_name, backward, pulls, monkeypatch):
    """Under ``pallas_midpoint`` the fused backward (its plain version on
    CPU tensors, the kernel on the card) runs once for each pull that
    reaches the ODE: the encoder's always, the decoder's where the decoder
    has leaves."""
    module = {"fused_ode": fused_ode, "fused_blackbox": fused_blackbox}[backward]
    calls = []
    orig = module._plain_bwd

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(module, "_plain_bwd", counted)
    model, prog, params, batch, mask, u = _port_inputs(spec_name, "pallas_midpoint")
    assert bool(T.param_leaves(params["dec"])) == (pulls == 2)
    T.dreg_value_and_grad(model, prog, params, batch, mask, u)
    assert len(calls) == pulls


def _second_pull_equals_a_fresh_graph(build):
    """``build()`` -> (output, inputs) of a fresh graph: two pulls on one
    graph, the second with another cotangent, against that cotangent's pull
    on a fresh graph."""
    gen = torch.Generator().manual_seed(3)
    out, inputs = build()
    g1, g2 = (torch.randn(out.shape, generator=gen) for _ in range(2))
    torch.autograd.grad(out, inputs, g1, retain_graph=True)
    second = torch.autograd.grad(out, inputs, g2)
    out, inputs = build()
    fresh = torch.autograd.grad(out, inputs, g2)
    for a, b in zip(second, fresh):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["dr", "dr_prec"])
def test_kind_backward_twice_on_one_context(kind):
    k = fused_ode.KINDS[kind]
    gen = torch.Generator().manual_seed(5)
    R = B * K
    times = torch.linspace(0.0, 20.0, 30)
    packed = (0.5 + torch.rand((len(k.names), R), generator=gen)).requires_grad_(True)
    y0 = (0.1 + torch.rand((k.n_states, R), generator=gen)).requires_grad_(True)
    wmat = (0.3 * torch.randn(k.wmat_shape, generator=gen)).requires_grad_(True) if k.prec else None
    inputs = [x for x in (wmat, packed, y0) if x is not None]
    _second_pull_equals_a_fresh_graph(lambda: (fused_ode._KindIntegrate.apply(
        kind, wmat, packed, y0, times, "midpoint"), inputs))


def test_blackbox_backward_twice_on_one_context():
    model, prog, params, batch, mask, u = _port_inputs("dr_blackbox_icml.yaml", "pallas_midpoint")
    ode = model.ode_model
    gen = torch.Generator().manual_seed(5)
    nets = params["dec"]
    constants = torch.randn((B, K, fused_blackbox.KERNEL_N_CONST), generator=gen)
    y0 = (1e-3 + 0.1 * torch.rand((B, K, ode.n_states + fused_blackbox.N_PREC), generator=gen))
    inputs = T.param_leaves({"states": nets["states"], "precisions": nets["precisions"]})
    inputs += [constants.requires_grad_(True), y0.requires_grad_(True)]
    _second_pull_equals_a_fresh_graph(lambda: (fused_blackbox.blackbox_simulate(
        nets, constants, y0, batch.times, ode.n_states, "midpoint"), inputs))


EPOCH_LINE = re.compile(r"^epoch +(\d+) \| train \(iwae-elbo = (\S+), .*\| val \(iwae-elbo = "
                        r"(\S+),", re.M)


def test_run_xval_trains_with_dreg(tmp_results, capsys):
    run_xval.main([spec("dr_constant_one.yaml"), "--experiment", "dreg", "--epochs", "2",
                   "--test_epoch", "1", "--train_samples", "4", "--test_samples", "4", "--seed",
                   "0", "--dreg", "--plot_epoch", "0"], device="cpu")
    lines = EPOCH_LINE.findall(capsys.readouterr().out)
    assert [int(e) for e, _, _ in lines] == [1, 2]
    assert all(np.isfinite(float(v)) for _, tr, va in lines for v in (tr, va))
    (run_dir,) = os.listdir(tmp_results)
    assert len([n for n in os.listdir(tmp_results / run_dir) if n.startswith("xval_")]) == 16
