"""The port's adaptive solvers (``ops/dopri.py``) and continuous adjoint
(``ops/adjoint.py``) against the JAX package on the CPU.

The same inputs, made by the JAX pipeline from a seed (converted params, a
theta drawn from the encoder and clipped), go through
``vihds_tpu.ops.solvers.integrate`` and the port's ``integrate``:

* each adaptive method's trajectory on tests/test_solvers.py's ``_setup``
  problem (dr_constant_one, 4 series x 3 draws, u from the JAX key) and on
  numpy draws (3 series x 4): rtol 1e-4, atol 1e-6 (measured: 1e-5 of the
  largest state at most; the two packages sum the stages in another order,
  so a step the one accepts at an error norm near 1 the other may reject);
* the adjoint's gradient with respect to y0, theta and the decoder's leaves
  (dr_constant_precisions' precision nets) against the JAX package's
  ``integrate_adjoint``: 1e-4 of each leaf's largest entry (the same
  algorithm; measured ~1e-6);
* the port's adjoint against its own discretise-then-differentiate rk4 at
  tests/test_solvers.py's 5e-2 / 1e-3, and the theta-only closure case of
  ``test_adaptive_theta_gradients`` at rtol 1e-4: it fails where the
  closure's tensors get no gradient;
* a second pull on one saved context, bit-equal to a fresh graph's.

Training through these routes (one step against the JAX loss, DReG, the
CLI) is held in tests/test_torch_adaptive_train.py.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_args, spec
from vihds_tpu.config import Config as JConfig
from vihds_tpu.data.datasets import build_datasets as j_build
from vihds_tpu.ops.adjoint import integrate_adjoint as j_integrate_adjoint
from vihds_tpu.ops.solvers import integrate as j_integrate
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu.training import batch_arrays
from vihds_tpu.vae import VAE as JVAE
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.convert import params_from_jax
from vihds_tpu_torch.data.datasets import build_datasets as t_build
from vihds_tpu_torch.ops import adjoint, dopri
from vihds_tpu_torch.ops.solvers import ADAPTIVE_SOLVERS, integrate
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.training import batch_tensors, param_leaves
from vihds_tpu_torch.vae import VAE as TVAE

METHODS = ["dopri5", "dopri8", "bosh3", "adaptive_heun"]


class Problem(SimpleNamespace):
    """One ODE problem in both packages: the JAX model's ``jrhs``, ``jy0``
    and ``jtimes``; the port's ``make_rhs``, ``args`` (its arguments),
    ``y0`` and ``times``; theta [B, K, n] as numpy."""


@functools.lru_cache(maxsize=None)
def problem(spec_name="dr_constant_one.yaml", draws="setup"):
    """``draws="setup"``: tests/test_solvers.py's ``_setup`` (4 series, K=3,
    u from ``PRNGKey(1)``); ``"numpy"``: 3 series, K=4, u from numpy's
    seeded generator.  Built once per file (no test writes to it)."""
    args = make_args(spec(spec_name))
    jset = JConfig(args)
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    jmodel = JVAE(jset, jdata, jprog)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    B, K = (4, 3) if draws == "setup" else (3, 4)
    host = jdata.train.dataset.select(np.arange(B))
    jbatch = batch_arrays(host)
    q = jmodel.encoder(jparams["enc"], jbatch)
    if draws == "setup":
        u = jmodel.sample_u(jax.random.PRNGKey(1), B, K)
    else:
        u = jnp.asarray(np.random.default_rng(5).standard_normal((B, K, jprog.n_theta))
                        .astype(np.float32))
    theta = np.asarray(jprog.clip(jprog.sample(q, u), stddevs=4))
    ode = jmodel.ode_model

    def jtheta(theta, dec):  # VAE.decode's conditioning
        th = jprog.theta_dict(theta)
        return ode.condition_theta(dec, th, jbatch.dev_1hot) if jmodel.condition_on_device else th

    th = jtheta(jnp.asarray(theta), jparams["dec"])
    jy0 = ode.initialize_state(jparams["dec"], th, jbatch.inputs, B, K)

    targs = SimpleNamespace(yaml=spec(spec_name), seed=0, folds=4, split=1, heldout=None)
    tset = TConfig(targs)
    tprog = TProgram(t_parse(tset.params))
    tmodel = TVAE(tset, t_build(targs, tset), tprog)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    batch = batch_tensors(host, slice(None), torch.as_tensor(host.times), "cpu")
    tode = tmodel.ode_model

    def ttheta(theta, dec):
        th = tprog.theta_dict(theta)
        return tode.condition_theta(dec, th, batch.dev_1hot) if tmodel.condition_on_device else th

    tth = ttheta(torch.as_tensor(theta.copy()), tparams["dec"])
    return Problem(
        jode=ode, jtheta=jtheta, ttheta=ttheta, jparams=jparams, jbatch=jbatch, jy0=jy0,
        jrhs=ode.make_rhs(jparams["dec"], th, jbatch.inputs, jbatch.dev_1hot),
        jtimes=jbatch.times, tode=tode, tparams=tparams, batch=batch,
        make_rhs=tode.make_rhs, args=(tparams["dec"], tth, batch.inputs, batch.dev_1hot),
        y0=tode.initialize_state(tparams["dec"], tth, batch.inputs, B, K),
        times=batch.times, theta=theta,
    )


@pytest.mark.parametrize("draws", ["setup", "numpy"])
@pytest.mark.parametrize("method", METHODS)
def test_adaptive_trajectory_matches_jax(method, draws):
    p = problem(draws=draws)
    ref = np.asarray(j_integrate(p.jrhs, p.jy0, p.jtimes, method=method))
    got = integrate((p.make_rhs, p.args), p.y0, p.times, method=method).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


def test_adaptive_integrator_keeps_the_jax_controller():
    """The step caps and orders of the JAX package's ``_STEPPERS``, and the
    forward of ``integrate_adaptive`` itself (no autograd Function) equal to
    the routed one bit for bit."""
    from vihds_tpu.ops import dopri as j_dopri

    assert sorted(dopri.ORDERS) == sorted(j_dopri._STEPPERS) == sorted(ADAPTIVE_SOLVERS)
    for method, (_, order) in j_dopri._STEPPERS.items():
        assert dopri.ORDERS[method] == order
        assert dopri.max_steps_default(method) == {2: 2048, 3: 512}.get(order, 64)
    p = problem(draws="numpy")
    rhs = p.make_rhs(*p.args)
    with torch.no_grad():
        direct = dopri.integrate_adaptive(rhs, p.y0, p.times, method="dopri5")
        routed = integrate((p.make_rhs, p.args), p.y0, p.times, method="dopri5")
    assert torch.equal(direct, routed)


def _leaf_close(got, ref, name):
    ref = np.asarray(ref)
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0, name
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max(), err_msg=name)


def _port_grads(p, method, w, adjoint_flag=True):
    """d sum(ys * w) / d (y0, theta, the decoder's leaves) through the
    port's ``integrate``."""
    y0 = p.y0.detach().clone().requires_grad_(True)
    theta = torch.as_tensor(p.theta.copy()).requires_grad_(True)
    dec = params_from_jax(jax.tree_util.tree_map(np.asarray, p.jparams["dec"]), device="cpu")
    for leaf in param_leaves(dec):
        leaf.requires_grad_(True)
    args = (dec, p.ttheta(theta, dec), p.batch.inputs, p.batch.dev_1hot)
    ys = integrate((p.make_rhs, args), y0, p.times, method=method, adjoint=adjoint_flag)
    (ys * torch.as_tensor(w)).sum().backward()
    return y0.grad, theta.grad, dec


@pytest.mark.parametrize(
    "spec_name,method",
    [("dr_constant_precisions.yaml", "dopri5"), ("dr_constant_precisions.yaml", "midpoint"),
     ("dr_constant_one.yaml", "bosh3")],
    ids=["precisions-dopri5", "precisions-adjoint-midpoint", "one-bosh3"],
)
def test_adjoint_gradients_match_jax(spec_name, method):
    p = problem(spec_name, draws="numpy")
    w = np.random.default_rng(11).standard_normal(
        (p.times.shape[0],) + tuple(p.y0.shape)).astype(np.float32)

    def loss(y0, theta, dec):
        r = p.jode.make_rhs(dec, p.jtheta(theta, dec), p.jbatch.inputs, p.jbatch.dev_1hot)
        return jnp.sum(j_integrate_adjoint(r, y0, p.jtimes, method=method) * w)

    jg = jax.grad(loss, argnums=(0, 1, 2))(p.jy0, jnp.asarray(p.theta), p.jparams["dec"])
    gy0, gtheta, dec = _port_grads(p, method, w)
    _leaf_close(gy0.numpy(), jg[0], "y0")
    _leaf_close(gtheta.numpy(), jg[1], "theta")
    leaves = jax.tree_util.tree_leaves_with_path(jg[2])
    assert len(leaves) == len(param_leaves(dec))
    if spec_name == "dr_constant_precisions.yaml":
        assert leaves  # the precision nets: the closure's own leaves
    for path, g in leaves:
        t = dec
        for k in path:
            t = t[k.key]
        _leaf_close(t.grad.numpy(), g, "dec" + jax.tree_util.keystr(path))


def test_adjoint_matches_its_own_rk4():
    """tests/test_solvers.py's ``test_adjoint_matches_direct_gradient`` on
    the port: the continuous adjoint's y0 gradient against backprop through
    the fixed-grid rk4, at its 5e-2 / 1e-3."""
    p = problem()

    def grad_y0(adjoint_flag):
        y0 = p.y0.detach().clone().requires_grad_(True)
        integrate((p.make_rhs, p.args), y0, p.times, method="rk4",
                  adjoint=adjoint_flag)[-1].sum().backward()
        return y0.grad.numpy()

    np.testing.assert_allclose(grad_y0(False), grad_y0(True), rtol=5e-2, atol=1e-3)


def test_adaptive_theta_gradients():
    """The theta-only case of tests/test_solvers.py's
    ``test_adaptive_theta_gradients``: gradient reaches a tensor the
    right-hand side closes over, and only through the closure (y0 does not
    depend on theta).  dopri5's adjoint against backprop through rk4 at
    rtol 1e-4, and against the JAX package's value."""

    def make_rhs(theta):
        def rhs(t, y):
            return -theta * y + torch.sin(t)

        return rhs

    times = torch.linspace(0.0, 2.0, 21)
    y0 = torch.tensor([1.0, 0.5])

    def grad(method):
        theta = torch.tensor(0.7, requires_grad=True)
        integrate((make_rhs, (theta,)), y0, times, method=method)[-1].sum().backward()
        assert theta.grad is not None, "no gradient reached the closure's tensor"
        return float(theta.grad)

    g5, g_ref = grad("dopri5"), grad("rk4")
    np.testing.assert_allclose(g5, g_ref, rtol=1e-4)

    def j_loss(theta):
        return jnp.sum(j_integrate(lambda t, y: -theta * y + jnp.sin(t), jnp.array([1.0, 0.5]),
                                   jnp.linspace(0.0, 2.0, 21), method="dopri5")[-1])

    np.testing.assert_allclose(g5, float(jax.grad(j_loss)(0.7)), rtol=1e-4)


def test_adjoint_needs_the_right_hand_sides_builder():
    """A bare closure would train y0 only, silently: the adjoint route
    refuses it."""
    times = torch.linspace(0.0, 1.0, 5)
    with pytest.raises(TypeError, match=r"\(make_rhs, args\)"):
        integrate(lambda t, y: -y, torch.ones(2), times, method="dopri5")
    with pytest.raises(ValueError, match="Unknown solver 'tsit5'.*adaptive"):
        integrate((lambda: (lambda t, y: -y), ()), torch.ones(2), times, method="tsit5")


def test_second_pull_on_one_context_is_bit_equal(method="dopri5"):
    """DReG pulls twice through one graph (``retain_graph``): the adjoint's
    backward run twice on one saved context gives what a fresh graph gives
    for each cotangent, bit for bit, in y0 and in the precision nets."""
    p = problem("dr_constant_precisions.yaml", draws="numpy")
    rng = np.random.default_rng(2)
    shape = (p.times.shape[0],) + tuple(p.y0.shape)
    cots = [torch.as_tensor(rng.standard_normal(shape).astype(np.float32)) for _ in range(2)]

    def graph():
        y0 = p.y0.detach().clone().requires_grad_(True)
        dec = params_from_jax(jax.tree_util.tree_map(np.asarray, p.jparams["dec"]), device="cpu")
        leaves = param_leaves(dec["precisions"])
        for leaf in leaves:
            leaf.requires_grad_(True)
        args = (dec, p.args[1], p.batch.inputs, p.batch.dev_1hot)
        ys = integrate((p.make_rhs, args), y0, p.times, method=method, adjoint=True)
        return ys, [y0] + leaves

    ys, inputs = graph()
    shared = [torch.autograd.grad(ys, inputs, c, retain_graph=i == 0)
              for i, c in enumerate(cots)]
    for c, got in zip(cots, shared):
        ys, inputs = graph()
        fresh = torch.autograd.grad(ys, inputs, c)
        assert len(fresh) > 1
        for a, b in zip(got, fresh):
            assert torch.equal(a, b)


def test_flatten_keeps_the_arguments_structure():
    from vihds_tpu_torch.utils.attrdict import AttrDict

    args = ({"a": torch.ones(2), "b": [torch.zeros(1), 3]}, AttrDict(c=torch.ones(1)), None)
    leaves = []
    skeleton = adjoint._flatten(args, leaves)
    assert len(leaves) == 3
    back = adjoint._unflatten(skeleton, leaves)
    assert isinstance(back[1], AttrDict) and back[1].c is leaves[2]
    assert back[0]["b"][1] == 3 and back[2] is None and back[0]["a"] is leaves[0]
