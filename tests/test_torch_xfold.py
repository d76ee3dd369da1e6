"""All folds in one batched step (``vihds_tpu_torch.xfold``, ``call_run_xval
--vmap_folds``) on the CPU, at B=3, K=4 and F=2.

Against the JAX package:

* one batched step (``training.loss_fn`` with ``folds``, its gradient
  through ``sum_f loss_f``) against ``jax.vmap(jax.value_and_grad(loss))``,
  two param sets from two JAX inits, different data rows and different ``u``
  per fold: on the fold route (``midpoint``), the ``dr`` kernel route, the
  ``dr_prec`` kernel route and the black-box kernel route (JAX's Pallas
  kernels in interpret mode, the port's plain versions on CPU tensors).
  Per-fold loss to rtol 1e-6, every leaf of every fold to 1e-4 of its
  largest entry (tests/test_torch_train.py's limits);
* the per-fold gradient clip against ``optax.clip_by_global_norm`` under
  ``jax.vmap``, rtol 1e-6;
* ``detect_outlier_folds`` and the fall-back reasons and messages, exactly.

Within the port:

* a NaN or a perturbation in fold 1's data leaves fold 0's loss and
  gradients bit-equal;
* the batched DReG step equals each fold's DReG step alone;
* the plain versions of the fold-axis kernels with F folds equal F separate
  calls, bit for bit;
* ``call_run_xval --vmap_folds`` against the sequential ``call_run_xval``:
  ``xval_elbo_list`` per fold to rtol 1e-3, ``xval_iw_predict_mu`` to atol
  1e-4, ``xval_ids`` exactly (the JAX package's tests/test_run_xval.py
  limits); a NaN fold frozen with the other fold's numbers bit-equal to the
  run without the NaN; a resume from ``checkpoints_vmap/`` equal to the
  uninterrupted run bit for bit; ``--rerun_outliers`` (adaptive solvers
  under the batched driver: tests/test_torch_adaptive_folds.py);
* ``HostWorker``: the figures it renders carry the tags of inline rendering,
  a raising figure does not stop the worker, ``VIHDS_SYNC_EVAL`` renders
  inline."""

import copy
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.conftest import make_args, spec
from vihds_tpu import xfold as j_xfold
from vihds_tpu.config import Config as JConfig
from vihds_tpu.data.datasets import build_datasets as j_build
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu.training import batch_arrays
from vihds_tpu.training import iwae_elbo as j_iwae_elbo
from vihds_tpu.training import iwae_elbo_terms as j_terms
from vihds_tpu.training import prior_as_q as j_prior_as_q
from vihds_tpu.utils.attrdict import AttrDict as JAttrDict
from vihds_tpu.vae import VAE as JVAE
from vihds_tpu_torch import call_run_xval, xfold
from vihds_tpu_torch import training as T
from vihds_tpu_torch.config import Config as TConfig, Trainer
from vihds_tpu_torch.convert import params_from_jax
from vihds_tpu_torch.data.datasets import build_datasets as t_build
from vihds_tpu_torch.ops import fused_blackbox as fb, fused_ode
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.run_xval import create_parser
from vihds_tpu_torch.utils.attrdict import AttrDict as TAttrDict
from vihds_tpu_torch.vae import VAE as TVAE

B, K, F = 3, 4, 2
KEYS = ("observations", "inputs", "dev_1hot")


# --------------------------------------------------------------------------
# one batched step against jax.vmap
# --------------------------------------------------------------------------
def _route_spy(monkeypatch, jmodel):
    """Send the JAX kernel route through its Pallas kernels in interpret mode
    (tests/test_pallas.py's spy); returns the list the spy appends to."""
    ode = jmodel.ode_model
    calls = []
    if ode.pallas_kinds is None:
        import vihds_tpu.ops.pallas_blackbox as mod

        name = "blackbox_simulate"
    else:
        import vihds_tpu.ops.pallas_ode as mod

        name = fused_ode.KINDS[ode.pallas_kinds[1 if ode.precisions.dynamic else 0]].simulate
    orig = getattr(mod, name)

    def spy(*a, **k):
        calls.append(1)
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(mod, name, spy)
    return calls


def _jax_batched(spec_name, solver, u, mask, monkeypatch):
    """jax.vmap(jax.value_and_grad(loss)) over two folds, compiled: two
    inits, data rows [0, B) and [B, 2B), the draws u[f], the masks mask[f].
    The loss does not checkpoint its integration (a cheaper compile; the
    function and its gradient are the same)."""
    args = make_args(spec(spec_name))
    jset = JConfig(args)
    jset.params.solver = solver
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    jmodel = JVAE(jset, jdata, jprog)
    params = [jmodel.init_params(jax.random.PRNGKey(f)) for f in range(F)]
    params_v = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *params)
    hosts = [jdata.train.dataset.select(np.arange(f * B, (f + 1) * B)) for f in range(F)]
    batches = [batch_arrays(h) for h in hosts]
    data_v = {k: jnp.stack([b[k] for b in batches]) for k in KEYS}
    times = batches[0].times
    calls = _route_spy(monkeypatch, jmodel) if solver.startswith("pallas_") else []

    def loss(p, d, uu, m):  # the body of make_step_fns.loss_fn
        batch = JAttrDict(d, times=times)
        if jmodel.ode_model.supports_fold():
            out = jmodel.forward_logprob(p, batch, uu, checkpoint=False)
            log_p_obs = out.log_p_by_species.sum(axis=2)
            terms = JAttrDict(log_w=log_p_obs + jprog.log_prob(j_prior_as_q(jprog), out.theta)
                              - jprog.log_prob(out.q, out.theta))
        else:
            out = jmodel.forward(p, batch, uu, checkpoint=False)
            terms = j_terms(jprog, out, batch, jmodel.use_laplace)
        return -j_iwae_elbo(terms, m)

    operands = (params_v, data_v, jnp.asarray(u), jnp.asarray(mask))
    values, grads = jax.jit(jax.vmap(jax.value_and_grad(loss)))(*operands)
    if jmodel.ode_model.precisions.dynamic:
        # XLA's fusion of the compiled loss moves this model's loss (tens of
        # nats, the difference of terms of ~1e3) by about 1e-6 relative, so
        # its losses are taken op by op, as tests/test_torch_train.py takes
        # every loss; the gradients stay compiled (rounding, far inside 1e-4)
        values = jax.vmap(loss)(*operands)
    if solver.startswith("pallas_"):
        assert calls, "the JAX kernel route was not taken"
    return params_v, hosts, np.asarray(values), grads


def _port_setup(spec_name, solver):
    targs = SimpleNamespace(yaml=spec(spec_name), seed=0, folds=4, split=1, heldout=None)
    tset = TConfig(targs)
    tset.params.solver = solver
    tdata = t_build(targs, tset)
    tprog = TProgram(t_parse(tset.params))
    return tdata, tprog, TVAE(tset, tdata, tprog)


def _fold_batch(hosts, device="cpu"):
    """The folds' host batches as one batch of F * B rows, fold-major."""
    batch = TAttrDict((k, torch.as_tensor(np.concatenate([h[k] for h in hosts]),
                                          dtype=torch.float32, device=device)) for k in KEYS)
    batch["times"] = torch.as_tensor(hosts[0].times, dtype=torch.float32, device=device)
    return batch


def _port_batched(tmodel, tprog, params_v, batch, u, mask):
    """The port's batched step: per-fold losses [F] and the leaves' grads."""
    tparams = params_from_jax(params_v, device="cpu")
    for leaf in T.param_leaves(tparams):
        leaf.requires_grad_(True)
    losses = T.loss_fn(tmodel, tprog, tparams, batch, torch.as_tensor(mask.reshape(-1)),
                       torch.as_tensor(u.reshape(F * B, K, -1)), folds=F)
    losses.sum().backward()
    return tparams, losses.detach().numpy()


ROUTES = {
    "fold-route": ("dr_constant_one.yaml", "midpoint"),
    "kernel-route": ("dr_constant_one.yaml", "pallas_midpoint"),
    "kernel-route-precisions": ("dr_constant_precisions.yaml", "pallas_midpoint"),
    "kernel-route-blackbox": ("dr_blackbox_icml.yaml", "pallas_midpoint"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_one_batched_step_matches_vmapped_jax(route, monkeypatch):
    spec_name, solver = ROUTES[route]
    tdata, tprog, tmodel = _port_setup(spec_name, solver)
    rng = np.random.default_rng(11)
    u = rng.standard_normal((F, B, K, tprog.n_theta)).astype(np.float32)
    mask = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0]], np.float32)  # fold 0 padded
    params_v, hosts, j_losses, j_grads = _jax_batched(spec_name, solver, u, mask, monkeypatch)
    np_params = jax.tree_util.tree_map(np.asarray, params_v)
    tparams, t_losses = _port_batched(tmodel, tprog, np_params, _fold_batch(hosts), u, mask)

    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-6)
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


@pytest.mark.parametrize("how", ["perturbed", "nan"])
def test_fold_1_leaves_fold_0_bit_equal(how):
    """Fold 1's data perturbed, or NaN, on the kernel route: fold 0's loss
    and every gradient entry of fold 0 stay bit-equal."""
    tdata, tprog, tmodel = _port_setup("dr_constant_precisions.yaml", "pallas_midpoint")
    gen = torch.Generator().manual_seed(0)
    params = xfold.stack_params(tmodel.init_params(gen, device="cpu"), F)
    hosts = [tdata.train.dataset.select(np.arange(f * B, (f + 1) * B)) for f in range(F)]
    rng = np.random.default_rng(3)
    u = rng.standard_normal((F * B, K, tprog.n_theta)).astype(np.float32)
    mask = torch.ones(F * B)

    def run(batch):
        p = copy.deepcopy(params)
        for leaf in T.param_leaves(p):
            leaf.requires_grad_(True)
        losses = T.loss_fn(tmodel, tprog, p, batch, mask, torch.as_tensor(u), folds=F)
        losses.sum().backward()
        return losses.detach(), [leaf.grad[0].clone() for leaf in T.param_leaves(p)]

    base = _fold_batch(hosts)
    ref_loss, ref_grads = run(base)
    other = TAttrDict(base)
    obs = base.observations.clone()
    obs[B:] = float("nan") if how == "nan" else obs[B:] * 1.5 + 0.25
    other["observations"] = obs
    loss, grads = run(other)
    assert bool(torch.isfinite(ref_loss).all())
    assert torch.equal(loss[0], ref_loss[0]) and not torch.equal(loss[1], ref_loss[1])
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)


def test_dreg_batched_step_equals_each_fold_alone():
    """``--dreg`` under the fold axis: the batched DReG step's per-fold
    -ELBO and every gradient leaf equal each fold's DReG step alone (the
    ``dr_prec`` kernel route, whose weight cotangent takes the fold axis),
    loss to rtol 1e-6, leaves to 1e-6 of their largest entry (the same
    arithmetic; the CPU's vectorised and scalar tails round apart)."""
    tdata, tprog, tmodel = _port_setup("dr_constant_precisions.yaml", "pallas_midpoint")
    params = xfold.stack_params(tmodel.init_params(torch.Generator().manual_seed(1),
                                                   device="cpu"), F)
    with torch.no_grad():  # folds apart: each fold's own weights
        for leaf in T.param_leaves(params):
            leaf[1] += 0.05 * torch.randn(leaf[1].shape, generator=torch.Generator().manual_seed(2))
    for leaf in T.param_leaves(params):
        leaf.requires_grad_(True)
    hosts = [tdata.train.dataset.select(np.arange(f * B, (f + 1) * B)) for f in range(F)]
    u = torch.as_tensor(np.random.default_rng(9).standard_normal((F * B, K, tprog.n_theta))
                        .astype(np.float32))
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0])
    losses, grads = T.dreg_value_and_grad(tmodel, tprog, params, _fold_batch(hosts), mask, u,
                                          folds=F)
    for f in range(F):
        def select(t):
            if isinstance(t, dict):
                return {k: select(v) for k, v in t.items()}
            return t.detach()[f].clone().requires_grad_(True)

        one = select(params)
        sl = slice(f * B, (f + 1) * B)
        loss, ref = T.dreg_value_and_grad(tmodel, tprog, one, _fold_batch(hosts[f:f + 1]),
                                          mask[sl], u[sl])
        np.testing.assert_allclose(float(losses[f]), float(loss), rtol=1e-6)
        for part in ("enc", "dec"):
            for got, want in zip(grads[part], ref[part]):
                scale = float(want.abs().max())
                assert scale > 0
                np.testing.assert_allclose(got[f].numpy(), want.numpy(), rtol=0,
                                           atol=1e-6 * scale)


def test_per_fold_clip_matches_vmapped_optax():
    """Two folds, one far above the clip norm and one below: each clipped by
    its own global norm, as ``optax.clip_by_global_norm`` under
    ``jax.vmap``."""
    rng = np.random.default_rng(5)
    grads = {"a": rng.standard_normal((F, 3)).astype(np.float32),
             "b": {"c": rng.standard_normal((F, 2, 2)).astype(np.float32)}}
    grads["a"][0] *= 20.0
    grads["b"]["c"][0] *= 20.0
    grads["a"][1] *= 0.1
    grads["b"]["c"][1] *= 0.1
    clip = 1.5
    tx = optax.clip_by_global_norm(clip)
    ref, _ = jax.vmap(lambda g: tx.update(g, tx.init(g)))(
        jax.tree_util.tree_map(jnp.asarray, grads))
    leaves = [torch.tensor(grads["a"]), torch.tensor(grads["b"]["c"])]
    scale = T.clip_scale(leaves, clip, folds=F)
    assert scale.shape == (F, 1) and float(scale[1, 0]) == 1.0 and float(scale[0, 0]) < 1.0
    for got, want in zip(leaves, (ref["a"], ref["b"]["c"])):
        got = got * scale.reshape((F,) + (1,) * (got.dim() - 1))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# --------------------------------------------------------------------------
# the plain versions of the fold-axis kernels
# --------------------------------------------------------------------------
def test_plain_prec_versions_with_folds_equal_separate_calls():
    rng = np.random.default_rng(2)
    kind, rf, T_ = "dr_prec", 5, 7
    k = fused_ode.KINDS[kind]
    wmat = torch.tensor(rng.standard_normal((F,) + k.wmat_shape).astype(np.float32) * 0.3)
    packed = torch.tensor(rng.uniform(0.1, 1.0, (len(k.names), F * rf)).astype(np.float32))
    y0 = torch.tensor(rng.uniform(0.1, 1.0, (k.n_states, F * rf)).astype(np.float32))
    times = torch.linspace(0.0, 3.0, T_)
    traj = fused_ode._plain_fwd(kind, wmat, packed, y0, times, "midpoint")
    g = torch.tensor(rng.standard_normal(traj.shape).astype(np.float32))
    dw, dc, dy0 = fused_ode._plain_bwd(kind, wmat, packed, times, traj, g, "midpoint")
    assert dw.shape == (F,) + k.wmat_shape
    for f in range(F):
        sl = slice(f * rf, (f + 1) * rf)
        one = fused_ode._plain_fwd(kind, wmat[f], packed[:, sl], y0[:, sl], times, "midpoint")
        assert torch.equal(traj[..., sl], one)
        ow, oc, oy = fused_ode._plain_bwd(kind, wmat[f], packed[:, sl], times, one,
                                          g[..., sl].contiguous(), "midpoint")
        assert torch.equal(dw[f], ow) and torch.equal(dc[:, sl], oc) and torch.equal(dy0[:, sl], oy)


def test_plain_blackbox_versions_with_folds_equal_separate_calls():
    rng = np.random.default_rng(4)
    rf, T_ = 3, 5
    shapes = fb.KERNEL_LEAF_SHAPES
    wflat = torch.tensor(rng.standard_normal((F, fb.KERNEL_N_W)).astype(np.float32) * 0.2)
    packed = torch.tensor(rng.uniform(-1, 1, (fb.KERNEL_N_CONST, F * rf)).astype(np.float32))
    y0 = torch.tensor(rng.uniform(0.1, 1.0, (fb.KERNEL_N_STATES + 4, F * rf)).astype(np.float32))
    times = torch.linspace(0.0, 2.0, T_)
    ns = fb.KERNEL_N_STATES
    traj = fb._plain_fwd_flat(wflat, shapes, packed, y0, times, ns, "midpoint")
    g = torch.tensor(rng.standard_normal(traj.shape).astype(np.float32))
    dw, dc, dy0 = fb._plain_bwd_flat(wflat, shapes, packed, times, traj, g, ns, "midpoint")
    assert dw.shape == (F, fb.KERNEL_N_W)
    for f in range(F):
        sl = slice(f * rf, (f + 1) * rf)
        one = fb._plain_fwd(fb._split(wflat[f], shapes), packed[:, sl], y0[:, sl], times, ns,
                            "midpoint")
        assert torch.equal(traj[..., sl], one)
        ow, oc, oy = fb._plain_bwd(fb._split(wflat[f], shapes), packed[:, sl], times, one,
                                   g[..., sl], ns, "midpoint")
        assert torch.equal(dw[f], torch.cat([d.reshape(-1) for d in ow]))
        assert torch.equal(dc[:, sl], oc) and torch.equal(dy0[:, sl], oy)


# --------------------------------------------------------------------------
# outliers and the fall-back, against the JAX package
# --------------------------------------------------------------------------
@pytest.mark.parametrize("elbos,nats", [
    ([-100.0, -110.0, -300.0, -105.0], 50.0),
    ([-100.0, None, -120.0, float("nan")], 10.0),
    ([-100.0, -99.0], 0.5),
    ([None, None], 50.0),
])
def test_detect_outlier_folds_matches_jax(elbos, nats):
    assert xfold.detect_outlier_folds(elbos, nats) == j_xfold.detect_outlier_folds(elbos, nats)


def _cli_args(argv):
    return create_parser(False).parse_args(argv)


@pytest.mark.parametrize("extra,merge", [
    ([], False), (["--folds", "1"], True), ([], True)], ids=["merge-false", "one-fold", "ok"])
def test_fallback_reasons_match_jax(extra, merge, capsys):
    args = _cli_args([spec("dr_constant_one.yaml")] + extra)
    settings = SimpleNamespace(data=SimpleNamespace(merge=merge))
    assert xfold.unsupported_reason(args, settings) == j_xfold.unsupported_reason(args, settings)
    args.heldout = "R33S32_Y81C76"
    assert xfold.unsupported_reason(args, settings) == j_xfold.unsupported_reason(args, settings)
    if merge and not extra:
        return
    args.heldout = None
    assert xfold.run_all_folds(args, settings, device="cpu") is None
    ported = capsys.readouterr().out
    assert j_xfold.run_all_folds(args, settings) is None
    assert ported == capsys.readouterr().out
    assert ported.startswith("vmap_folds: falling back to sequential folds (")


def test_unequal_fold_grids_fall_back_with_the_jax_message(tmp_results, capsys):
    """5 folds of dr_constant_one's 312 series leave folds of 62 and 63
    validation series: with n_batch 2 their chunk counts differ."""
    argv = [spec("dr_constant_one.yaml"), "--folds", "5", "--seed", "0"]
    args = _cli_args(argv)
    settings = TConfig(args)
    settings.params.n_batch = 2
    jargs = make_args(spec("dr_constant_one.yaml"), folds=5)
    jset = JConfig(jargs)
    jset.params.n_batch = 2
    with pytest.raises(xfold.UnsupportedVmapXval) as got:
        xfold.VmapXval(args, settings, device="cpu")
    with pytest.raises(j_xfold.UnsupportedVmapXval) as want:
        j_xfold.VmapXval(jargs, jset)
    assert str(got.value) == str(want.value)
    capsys.readouterr()


# --------------------------------------------------------------------------
# the CLI against the sequential driver
# --------------------------------------------------------------------------
BASE = [spec("dr_constant_one.yaml"), "--epochs", "2", "--test_epoch", "1", "--folds", "2",
        "--train_samples", "4", "--test_samples", "4", "--seed", "0", "--plot_epoch", "0"]


def _xval(name, extra=()):
    """``call_run_xval.main`` (the caller leaves the xval figures out);
    returns the run's directory and its XvalMerge."""
    merge = call_run_xval.main(BASE + ["--experiment", name] + list(extra), device="cpu")
    return merge.trainer.tb_log_dir, merge


class _Recorded(xfold.VmapXval):
    """The runner, kept for the tests that read its state after the run."""

    made = []

    def run(self):
        _Recorded.made.append(self)
        self.results = super().run()
        return self.results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sequential and the batched 2-fold run, 2 epochs each, shared by
    the CLI tests, without TensorBoard writers (their files are held in
    tests/test_torch_summaries.py) or xval figures."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("xfold_results")
    mp.setenv("INFERENCE_RESULTS_DIR", str(root))
    mp.setattr(call_run_xval, "write_figures", lambda merge: None)
    mp.setattr(call_run_xval, "missing_packages", lambda names: [])
    mp.setattr(xfold, "summary_writer", lambda path: None)
    mp.setattr(T, "summary_writer", lambda path: None)
    mp.setattr(xfold, "VmapXval", _Recorded)
    try:
        seq = _xval("seq")
        vm = _xval("vm", ["--vmap_folds", "--checkpoint_epoch", "1"])
        yield SimpleNamespace(root=root, seq=seq, vm=vm, runner=_Recorded.made[-1])
    finally:
        mp.undo()


def test_vmap_folds_matches_the_sequential_driver(runs):
    (seq_dir, _), (vm_dir, _) = runs.seq, runs.vm
    load = lambda d, n: np.load(os.path.join(d, "xval_%s.npy" % n), allow_pickle=True)  # noqa
    for f, (a, b) in enumerate(zip(load(vm_dir, "elbo_list"), load(seq_dir, "elbo_list"))):
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=1e-3,
                                   err_msg="fold %d" % (f + 1))
    np.testing.assert_allclose(load(vm_dir, "iw_predict_mu"), load(seq_dir, "iw_predict_mu"),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(load(vm_dir, "ids"), load(seq_dir, "ids"))
    for n in (1, 2):
        assert os.path.isdir(os.path.join(vm_dir, ".vihds_cache_%d_of_2" % n))
    assert sorted(os.listdir(os.path.join(vm_dir, "checkpoints_vmap"))) == ["1.pt", "2.pt"]


def test_resume_from_checkpoints_vmap_follows_the_run(runs, capsys, tmp_path):
    """Resumed from the epoch-1 checkpoint, epoch 2 ends on the uninterrupted
    run's params, bit for bit."""
    vm_dir, whole = runs.vm[0], runs.runner
    shutil.copy(os.path.join(vm_dir, "checkpoints_vmap", "1.pt"), tmp_path)
    resumed = xfold.VmapXval(
        _cli_args(BASE + ["--vmap_folds", "--resume_from", str(tmp_path)]),
        _settings(runs), device="cpu")
    resumed.run()
    assert "Resumed vmapped folds from" in capsys.readouterr().out
    assert len(resumed.step_ms) == whole.steps_per_epoch  # only epoch 2 ran
    for a, b in zip(T.param_leaves(whole.final_params), T.param_leaves(resumed.final_params)):
        assert torch.equal(a, b)


def _settings(runs):
    """A spec's settings for a runner that writes under the shared results
    directory."""
    args = _cli_args(BASE + ["--experiment", "direct"])
    settings = TConfig(args)
    settings.trainer = Trainer(args, add_timestamp=True)
    return settings


def test_nan_fold_is_frozen_and_the_other_fold_unchanged(runs, capsys, monkeypatch):
    """Fold 2's train data NaN: fold 2 is frozen after its first chunk and
    leaves no results; fold 1's ELBO list is the clean run's, bit for bit."""
    clean_results = runs.runner.results
    runner = xfold.VmapXval(_cli_args(BASE + ["--vmap_folds"]), _settings(runs), device="cpu")
    orig = runner._train_data

    def poisoned(device, *folds):
        data, n_max = orig(device, *folds)
        data["observations"][n_max:] = float("nan")
        return data, n_max

    monkeypatch.setattr(runner, "_train_data", poisoned)
    results = runner.run()
    out = capsys.readouterr().out
    assert "Fold 2: ELBO = nan, freezing this fold." in out
    assert "Fold 2: no results in cache" in out
    assert results[1] is None
    assert results[0].elbo_list == clean_results[0].elbo_list
    assert "epoch    2 | fold 1" in out and "epoch    2 | fold 2" not in out


def test_rerun_outliers_retrains_through_the_sequential_driver(runs, capsys):
    """``--outlier_nats`` forced low flags the lower fold; ``--rerun_outliers``
    retrains it sequentially under seed + 10007 + f and keeps the better."""
    args = _cli_args(BASE + ["--vmap_folds", "--rerun_outliers", "--outlier_nats", "1e-3",
                             "--epochs", "1"])
    settings = _settings(runs)
    got = xfold.run_all_folds(args, settings, device="cpu")
    out = capsys.readouterr().out
    assert "WARNING: 1 of 2 folds landed > 0 nats below the sibling median" in out
    f = [i for i in range(2) if "Rerunning fold %d sequentially with training seed %d" % (
        i + 1, 10007 + i) in out]
    assert len(f) == 1
    assert ("Fold %d recovered" % (f[0] + 1) in out) != ("Fold %d rerun did not improve"
                                                          % (f[0] + 1) in out)
    assert [s for s, _, _ in got] == [1, 2] and all(r is not None for _, _, r in got)


# --------------------------------------------------------------------------
# HostWorker
# --------------------------------------------------------------------------
def test_host_worker_runs_in_order_and_survives_a_raising_figure(capsys):
    worker = T.HostWorker()
    done = []

    def bad():
        raise RuntimeError("a figure failed")

    for fn in (lambda: done.append(1), bad, lambda: done.append(2)):
        worker.submit(fn)
    worker.join()
    assert done == [1, 2]
    assert "RuntimeError: a figure failed" in capsys.readouterr().err


def test_sync_eval_renders_inline(monkeypatch):
    settings = SimpleNamespace(trainer=object())
    monkeypatch.delenv("VIHDS_SYNC_EVAL", raising=False)
    worker = T.HostWorker.for_run(settings)
    assert isinstance(worker, T.HostWorker)
    worker.join()
    monkeypatch.setenv("VIHDS_SYNC_EVAL", "1")
    assert T.HostWorker.for_run(settings) is None
    assert T.HostWorker.for_run(SimpleNamespace(trainer=None)) is None
    seen = []
    T.run_on(None, lambda: seen.append(1))
    assert seen == [1]


class _Writer:
    """A stand-in for a SummaryWriter that records what is written: each
    scalar's tag and step, each figure's tag, step and artists (axes, lines
    and collections per axes)."""

    def __init__(self, path):
        self.log_dir = path
        self.records = _Writer.written.setdefault(os.path.basename(path), [])

    written = {}

    def add_scalar(self, tag, value, step):
        self.records.append(("scalar", tag, step))

    def add_histogram(self, tag, value, step):
        self.records.append(("histogram", tag, step))

    def add_figure(self, tag, fig, global_step=None):
        artists = [(len(ax.lines), len(ax.collections), len(ax.patches)) for ax in fig.axes]
        self.records.append(("figure", tag, global_step, artists))

    def flush(self):
        pass

    def close(self):
        pass


def test_host_worker_figures_carry_the_inline_tags(runs, monkeypatch, capsys):
    """One epoch of ``run_xval`` with its figures: rendered on the worker
    they write what inline rendering (``VIHDS_SYNC_EVAL``) writes, tag for
    tag and artist for artist; a figure that raises on the worker does not
    stop the run."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("seaborn")
    from vihds_tpu_torch import plotting_hooks, run_xval

    monkeypatch.setattr(T, "summary_writer", _Writer)
    real = plotting_hooks.eval_plots

    def raising(training, writer, *a, **k):
        real(training, writer, *a, **k)
        if os.environ.get("VIHDS_SYNC_EVAL") is None and "valid" in writer.log_dir:
            raise RuntimeError("a figure failed")

    monkeypatch.setattr(plotting_hooks, "eval_plots", raising)
    written = {}
    for mode in ("worker", "inline"):
        if mode == "inline":
            monkeypatch.setenv("VIHDS_SYNC_EVAL", "1")
        else:
            monkeypatch.delenv("VIHDS_SYNC_EVAL", raising=False)
        _Writer.written = {}
        run_xval.main([spec("dr_constant_one.yaml"), "--experiment", "hw", "--epochs", "1",
                       "--test_epoch", "1", "--plot_epoch", "1", "--train_samples", "4",
                       "--test_samples", "4", "--seed", "0"], device="cpu")
        written[mode] = _Writer.written
    assert "RuntimeError: a figure failed" in capsys.readouterr().err
    assert sorted(written["worker"]) == ["train_1_of_4", "valid_1_of_4"]
    assert written["worker"] == written["inline"]
    for records in written["worker"].values():
        assert [r[1] for r in records if r[0] == "figure"] == ["Summary"]
