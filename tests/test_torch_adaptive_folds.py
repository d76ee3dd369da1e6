"""Per-fold adaptive step control (``--vmap_folds`` under an adaptive solver
or the continuous adjoint) on the CPU, against ``jax.vmap`` of the JAX
package.

* ``ops.dopri.integrate_adaptive(folds=3)`` against ``jax.vmap`` of
  ``vihds_tpu.ops.dopri.integrate_adaptive`` over 3 folds of
  dr_constant_one (4 series x 8 draws each, numpy draws; the first 25 grid
  times; rtol 1e-5, atol 1e-7, which keeps adaptive_heun to ~1,800 steps),
  the folds' growth rates scaled by 1, 2 and 4 so that they take different
  steps: for each of the four methods, the trajectories within rtol 1e-4,
  atol 1e-6 (tests/test_torch_adaptive.py's limits: the two packages sum
  the stages in another order);
* each fold's attempted and accepted steps per interval equal to the
  port's own run on that fold alone, its trajectory bit-equal, and the
  folds' counts not all equal.  A fold's [B, K] block holds 32 elements:
  on the CPU PyTorch's elementwise kernels run a tensor in chunks of two
  512-bit vectors and its remainder through the scalar function (another
  rounding of exp and pow), so a fold's elements round alike in both runs
  only where its blocks are whole chunks (on the card every element rounds
  alike);
* one fold-batched training step (``training.loss_fn(folds=2)`` and the
  gradient of the folds' summed loss) under dopri5 (the adjoint's route)
  and under midpoint with ``adjoint_solver: true``, against
  ``jax.vmap(jax.value_and_grad(loss))`` of the JAX loss: two inits, two
  batches, two draws: the loss to rtol 1e-4, every gradient leaf of every
  fold within 1e-4 of its largest entry;
* ``call_run_xval --vmap_folds --folds 2 --epochs 1`` under dopri5 against
  the port's sequential folds: each fold's ELBOs to rtol 1e-4 and the
  ``xval_*`` artifacts written.
"""

import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_args, spec
from vihds_tpu.config import Config as JConfig
from vihds_tpu.data.datasets import build_datasets as j_build
from vihds_tpu.ops import dopri as j_dopri
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu.training import batch_arrays
from vihds_tpu.training import iwae_elbo as j_iwae_elbo
from vihds_tpu.training import iwae_elbo_terms as j_terms
from vihds_tpu.utils.attrdict import AttrDict as JAttrDict
from vihds_tpu.vae import VAE as JVAE
from vihds_tpu_torch import call_run_xval, xfold
from vihds_tpu_torch import training as T
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.convert import params_from_jax
from vihds_tpu_torch.data.datasets import build_datasets as t_build
from vihds_tpu_torch.ops import dopri
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.utils.attrdict import AttrDict as TAttrDict
from vihds_tpu_torch.vae import VAE as TVAE

METHODS = ["dopri5", "dopri8", "bosh3", "adaptive_heun"]
SPEC = "dr_constant_one.yaml"
B, K = 4, 8
#: each fold's factor on the growth rate r: a stiffer fold takes more steps
RATE_SCALES = (1.0, 2.0, 4.0)
#: the grid's first times and the controller's tolerances of (a) and (b)
N_TIMES, TOLS = 25, dict(rtol=1e-5, atol=1e-7)
KEYS = ("observations", "inputs", "dev_1hot")


def _jax_model(solver="midpoint", adjoint=False):
    args = make_args(spec(SPEC))
    jset = JConfig(args)
    jset.params.solver = solver
    jset.params.adjoint_solver = adjoint
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    return JVAE(jset, jdata, jprog), jprog, jdata


def _port_model(solver="midpoint", adjoint=False):
    targs = SimpleNamespace(yaml=spec(SPEC), seed=0, folds=4, split=1, heldout=None)
    tset = TConfig(targs)
    tset.params.solver = solver
    tset.params.adjoint_solver = adjoint
    tprog = TProgram(t_parse(tset.params))
    return TVAE(tset, t_build(targs, tset), tprog), tprog


@functools.lru_cache(maxsize=None)
def problem():
    """The folds' right-hand sides in both packages: one series block and
    one theta draw (clipped, conditioned), fold f's growth rate scaled by
    ``RATE_SCALES[f]``.  Built once per file (no test writes to it)."""
    jmodel, jprog, jdata = _jax_model()
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    host = jdata.train.dataset.select(np.arange(B))
    jbatch = batch_arrays(host)
    q = jmodel.encoder(jparams["enc"], jbatch)
    u = jnp.asarray(np.random.default_rng(5).standard_normal((B, K, jprog.n_theta))
                    .astype(np.float32))
    theta = np.asarray(jprog.clip(jprog.sample(q, u), stddevs=4))
    jode = jmodel.ode_model
    th = jode.condition_theta(jparams["dec"], jprog.theta_dict(jnp.asarray(theta)),
                              jbatch.dev_1hot)
    # [F, B, K] leaves: fold f's draw, its growth rate scaled
    th_f = {k: jnp.stack([v * s if k == "r" else v for s in RATE_SCALES]) for k, v in th.items()}
    jy0 = jode.initialize_state(jparams["dec"], th, jbatch.inputs, B, K)

    tmodel, tprog = _port_model()
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tode = tmodel.ode_model
    F = len(RATE_SCALES)
    inputs = torch.as_tensor(np.asarray(jbatch.inputs))
    dev = torch.as_tensor(np.asarray(jbatch.dev_1hot))
    tth = {k: torch.as_tensor(np.asarray(v)).reshape((F * B,) + tuple(v.shape[2:]))
           for k, v in th_f.items()}
    return SimpleNamespace(
        jode=jode, jdec=jparams["dec"], th_f=th_f, jy0=jy0, jbatch=jbatch,
        tode=tode, tdec=tparams["dec"], tth=tth, inputs=inputs.repeat(F, 1),
        dev=dev.repeat(F, 1), ty0=torch.as_tensor(np.asarray(jy0)).repeat(F, 1, 1),
        jtimes=jbatch.times[:N_TIMES], times=torch.as_tensor(np.asarray(jbatch.times))[:N_TIMES],
        F=F,
    )


@functools.lru_cache(maxsize=None)
def jax_folds(method):
    """``jax.vmap`` of the JAX integrator over the folds: [F, T, B, K, S]."""
    p = problem()

    def one(th):
        rhs = p.jode.make_rhs(p.jdec, th, p.jbatch.inputs, p.jbatch.dev_1hot)
        return j_dopri.integrate_adaptive(rhs, p.jy0, p.jtimes, method=method, **TOLS)

    return np.asarray(jax.jit(jax.vmap(one))(p.th_f))


def port_folds(method, stats=None):
    """The port's fold-batched forward: [T, F * B, K, S]."""
    p = problem()
    rhs = p.tode.make_rhs(p.tdec, p.tth, p.inputs, p.dev)
    with torch.no_grad():
        return dopri.integrate_adaptive(rhs, p.ty0, p.times, method=method, folds=p.F,
                                        stats=stats, **TOLS)


def port_one_fold(method, f, stats=None):
    """The port's run on fold f alone (no fold axis): [T, B, K, S]."""
    p = problem()
    rows = slice(f * B, (f + 1) * B)
    th = {k: v[rows] for k, v in p.tth.items()}
    rhs = p.tode.make_rhs(p.tdec, th, p.inputs[rows], p.dev[rows])
    with torch.no_grad():
        return dopri.integrate_adaptive(rhs, p.ty0[rows], p.times, method=method, stats=stats,
                                        **TOLS)


@pytest.mark.parametrize("method", METHODS)
def test_fold_trajectories_match_vmapped_jax(method):
    p = problem()
    ref = jax_folds(method)                                   # [F, T, B, K, S]
    got = port_folds(method).numpy()                          # [T, F * B, K, S]
    got = got.reshape((got.shape[0], p.F, B) + got.shape[2:]).transpose(1, 0, 2, 3, 4)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("method", METHODS)
def test_each_fold_takes_its_own_steps(method):
    """Each fold's attempted (and accepted) steps per interval are those of
    the port's run on that fold alone, and the stiffer folds take more."""
    p = problem()
    stats = {}
    got = port_folds(method, stats)
    totals = []
    for f in range(p.F):
        alone = {}
        ys = port_one_fold(method, f, alone)
        np.testing.assert_array_equal(stats["attempted"][:, f].numpy(),
                                      alone["attempted"].numpy(), err_msg="fold %d" % f)
        np.testing.assert_array_equal(stats["accepted"][:, f].numpy(),
                                      alone["accepted"].numpy(), err_msg="fold %d" % f)
        np.testing.assert_array_equal(got[:, f * B:(f + 1) * B].numpy(), ys.numpy(),
                                      err_msg="fold %d" % f)
        totals.append(int(alone["attempted"].sum()))
    assert len(set(totals)) > 1, totals


# --------------------------------------------------------------------------
# one fold-batched training step against jax.vmap of the JAX loss
# --------------------------------------------------------------------------
STEP_F, STEP_B, STEP_K = 2, 3, 4
STEP_CASES = {"dopri5": ("dr_constant_precisions.yaml", "dopri5", False),
              "adjoint-midpoint": ("dr_constant_one.yaml", "midpoint", True)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_batched_step_matches_vmapped_jax(case):
    """Two inits, data rows [0, B) and [B, 2B), a draw u per fold and a
    padded row in fold 0; the trajectory route (``supports_fold`` is False
    in both packages)."""
    spec_name, solver, adjoint = STEP_CASES[case]
    F, B_, K_ = STEP_F, STEP_B, STEP_K
    args = make_args(spec(spec_name))
    jset = JConfig(args)
    jset.params.solver = solver
    jset.params.adjoint_solver = adjoint
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    jmodel = JVAE(jset, jdata, jprog)
    assert not jmodel.ode_model.supports_fold()
    params_v = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                      *[jmodel.init_params(jax.random.PRNGKey(f))
                                        for f in range(F)])
    hosts = [jdata.train.dataset.select(np.arange(f * B_, (f + 1) * B_)) for f in range(F)]
    batches = [batch_arrays(h) for h in hosts]
    data_v = {k: jnp.stack([b[k] for b in batches]) for k in KEYS}
    times = batches[0].times
    u = np.random.default_rng(11).standard_normal((F, B_, K_, jprog.n_theta)).astype(np.float32)
    mask = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0]], np.float32)

    def loss(p, d, uu, m):  # make_step_fns.loss_fn's trajectory route
        batch = JAttrDict(d, times=times)
        out = jmodel.forward(p, batch, uu, checkpoint=False)
        return -j_iwae_elbo(j_terms(jprog, out, batch, jmodel.use_laplace), m)

    j_losses, j_grads = jax.jit(jax.vmap(jax.value_and_grad(loss)))(
        params_v, data_v, jnp.asarray(u), jnp.asarray(mask))

    tsettings = TConfig(SimpleNamespace(yaml=spec(spec_name), seed=0, folds=4, split=1,
                                        heldout=None))
    tsettings.params.solver = solver
    tsettings.params.adjoint_solver = adjoint
    tprog = TProgram(t_parse(tsettings.params))
    tmodel = TVAE(tsettings, t_build(SimpleNamespace(yaml=spec(spec_name), seed=0, folds=4,
                                                     split=1, heldout=None), tsettings), tprog)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params_v), device="cpu")
    for leaf in T.param_leaves(tparams):
        leaf.requires_grad_(True)
    batch = TAttrDict((k, torch.as_tensor(np.concatenate([h[k] for h in hosts]),
                                          dtype=torch.float32)) for k in KEYS)
    batch["times"] = torch.as_tensor(hosts[0].times, dtype=torch.float32)
    losses = T.loss_fn(tmodel, tprog, tparams, batch, torch.as_tensor(mask.reshape(-1)),
                       torch.as_tensor(u.reshape(F * B_, K_, -1)), folds=F)
    losses.sum().backward()

    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(j_losses), rtol=1e-4)
    leaves = jax.tree_util.tree_leaves_with_path(j_grads)
    assert len(leaves) == len(T.param_leaves(tparams))
    for path, g in leaves:
        t = tparams
        for p in path:
            t = t[p.key]
        ref, got = np.asarray(g), t.grad.numpy()
        assert got.shape == ref.shape and ref.shape[0] == F
        for f in range(F):  # each fold's leaf to 1e-4 of its own largest entry
            assert np.isfinite(ref[f]).all() and np.abs(ref[f]).max() > 0
            np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=1e-4 * np.abs(ref[f]).max(),
                                       err_msg="%s fold %d" % (jax.tree_util.keystr(path), f))


# --------------------------------------------------------------------------
# the CLI: call_run_xval --vmap_folds under dopri5
# --------------------------------------------------------------------------
def test_vmap_folds_trains_under_dopri5_as_the_sequential_folds(tmp_path, monkeypatch):
    """``call_run_xval --vmap_folds`` on a spec that names ``solver:
    dopri5``, 2 folds x 1 epoch, against the sequential driver: each fold's
    ELBOs to rtol 1e-4 and the xval artifacts of both runs."""
    import yaml

    root = tmp_path / "results"
    monkeypatch.setenv("INFERENCE_RESULTS_DIR", str(root))
    monkeypatch.setattr(call_run_xval, "write_figures", lambda merge: None)
    monkeypatch.setattr(call_run_xval, "missing_packages", lambda names: [])
    monkeypatch.setattr(xfold, "summary_writer", lambda path: None)
    monkeypatch.setattr(T, "summary_writer", lambda path: None)
    with open(spec(SPEC)) as f:
        doc = yaml.safe_load(f)
    doc["params"]["solver"] = "dopri5"
    path = tmp_path / "dr_constant_one_dopri5.yaml"
    path.write_text(yaml.safe_dump(doc))
    base = [str(path), "--epochs", "1", "--test_epoch", "1", "--folds", "2",
            "--train_samples", "2", "--test_samples", "2", "--seed", "0", "--plot_epoch", "0"]
    dirs = {}
    for name, extra in (("seq", []), ("vm", ["--vmap_folds"])):
        merge = call_run_xval.main(base + ["--experiment", name] + extra, device="cpu")
        dirs[name] = merge.trainer.tb_log_dir
        names = os.listdir(dirs[name])
        assert "completed.txt" in names
        assert len([n for n in names if n.startswith("xval_")]) == 16

    def load(name, what):
        return np.load(os.path.join(dirs[name], "xval_%s.npy" % what), allow_pickle=True)

    for f, (a, b) in enumerate(zip(load("vm", "elbo_list"), load("seq", "elbo_list"))):
        a, b = np.asarray(a, float), np.asarray(b, float)
        assert a.shape == b.shape == (1,) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-4, err_msg="fold %d" % (f + 1))
    np.testing.assert_array_equal(load("vm", "ids"), load("seq", "ids"))
