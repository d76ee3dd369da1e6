"""``merge: false`` data in the port against the JAX package, on
``dr_constant_icml_unmerged`` (six CSVs, five on a 100-point grid and one on
86 points):

* ``MultiTimeSeriesDataset``: every array, the scales, the encoder's snap
  indices ``enc_idx``, each file's times, ``group_by_file`` and
  ``file_batch``, at splits 1 and 2, exactly (both packages run the same
  numpy code on the same files);
* the multi-file training path's per-epoch batch orders (the JAX package's
  ``_run_multi_epochs``, its step function replaced by a recorder), exactly;
* one training step on one file's rows (B=3, K=4, the same converted params
  and draws ``u``): the loss to rtol 1e-6 and each gradient leaf to 1e-4 of
  its largest entry, on the spec's fold route and on the kernel route (the
  JAX package through its Pallas kernel in interpret mode);
* the file-by-file evaluation of a validation split, merged back onto the
  shortest grid, given the draws the JAX package's keys make, to rtol 1e-5
  (the predictive std through its second moment, ``std^2 + mu^2``);
* the ``xval_*`` set that ``XvalMerge`` writes for the split, exactly.
"""

import math
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
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu.training import Training as JTraining
from vihds_tpu.training import iwae_elbo as j_iwae_elbo
from vihds_tpu.training import iwae_elbo_terms as j_terms
from vihds_tpu.training import prior_as_q as j_prior_as_q
from vihds_tpu.utils.attrdict import AttrDict as JAttrDict
from vihds_tpu.vae import VAE as JVAE
from vihds_tpu_torch import training as T
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.convert import params_from_jax
from vihds_tpu_torch.data.datasets import build_datasets as t_build
from vihds_tpu_torch.ops import fused_ode
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.vae import VAE as TVAE

SPEC = "dr_constant_icml_unmerged.yaml"
B, K = 3, 4
IW = ("iw_predict_mu", "iw_predict_std")


def _jax(split=1, solver=None, **kw):
    args = make_args(spec(SPEC), split=split, **kw)
    jset = JConfig(args)
    jset.trainer = None
    if solver:
        jset.params.solver = solver
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    jmodel = JVAE(jset, jdata, jprog)
    return args, jset, jdata, jprog, jmodel


def _port(split=1, solver=None):
    targs = SimpleNamespace(yaml=spec(SPEC), seed=0, folds=4, split=split, heldout=None)
    tset = TConfig(targs)
    if solver:
        tset.params.solver = solver
    tdata = t_build(targs, tset)
    tprog = TProgram(t_parse(tset.params))
    tmodel = TVAE(tset, tdata, tprog)
    return targs, tset, tdata, tprog, tmodel


def _port_params(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("split", [1, 2])
def test_multi_dataset_matches_jax(split):
    _, _, jdata, _, _ = _jax(split)
    _, _, tdata, _, _ = _port(split)
    jd, td = jdata.train.dataset, tdata.train.dataset
    assert type(td).__name__ == "MultiTimeSeriesDataset"
    assert len(jd) == len(td) == 312
    np.testing.assert_array_equal(np.asarray(jd.scales), np.asarray(td.scales))
    for name in ("times", "devices", "file_of", "local_of"):
        a, b = getattr(jd, name), getattr(td, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert jd.n_times == td.n_times == 86 and jd.n_species == td.n_species
    assert len(jd.files) == len(td.files) == 6
    for f, (a, b) in enumerate(zip(jd.files, td.files)):
        np.testing.assert_array_equal(jd.enc_idx[f], td.enc_idx[f])
        for name in ("times", "devices", "dev_1hot", "inputs", "observations"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype, (f, name)
            np.testing.assert_array_equal(x, y, err_msg="file %d %s" % (f, name))
    assert sorted({f.n_times for f in td.files}) == [86, 100]
    np.testing.assert_array_equal(jdata.train.indices, tdata.train.indices)
    np.testing.assert_array_equal(jdata.test.indices, tdata.test.indices)
    for ids in (jdata.train.indices, jdata.test.indices):
        jg, tg = jd.group_by_file(ids), td.group_by_file(ids)
        assert [g[0] for g in jg] == [g[0] for g in tg]
        for (fi, jl, jp), (_, tl, tp) in zip(jg, tg):
            np.testing.assert_array_equal(jl, tl)
            np.testing.assert_array_equal(jp, tp)
            jb, tb = jd.file_batch(fi, jl), td.file_batch(fi, tl)
            assert set(jb) == set(tb)
            for name in jb:
                np.testing.assert_array_equal(jb[name], tb[name], err_msg="file %d %s" % (fi, name))
    for ids in (jdata.test.indices, np.arange(10)):
        jv, tv = jd.select(ids), td.select(ids)
        for name in jv:
            np.testing.assert_array_equal(jv[name], tv[name], err_msg=name)
    if split == 1:
        assert [len(p) for _, _, p in td.group_by_file(tdata.train.indices)] == [71, 71, 34, 14,
                                                                                 22, 22]


def test_multi_epoch_batch_orders_match_jax():
    """Epochs 1-3 of split 1 at B=36: the JAX package's per-file index grids
    and masks, recorded at its step function, equal the port's, in the
    order the port steps through them; 8 optimizer steps an epoch."""
    args, jset, jdata, jprog, jmodel = _jax(1)
    jt = JTraining(args, jset, jdata, jprog, jmodel)
    recorded = []

    def record(params, opt_state, key, stacks, data, times):
        recorded.append((np.asarray(stacks.idx), np.asarray(stacks.mask), times.shape[0]))
        return params, opt_state, key, np.zeros(stacks.idx.shape[0], np.float32)

    jt._train_epoch = record
    jt._run_multi_epochs(None, None, None, 0, 1, 3)

    _, tset, tdata, tprog, tmodel = _port(1)
    tt = T.Training(tset, tdata, tprog, tmodel, device="cpu")
    assert tt.steps_per_epoch == jt.steps_per_epoch == 8 and tt.n_batch == 36
    sizes = [host.observations.shape[0] for _, host, _ in tt.train_groups]
    ours = [(s["idx"], s["mask"], host.times.shape[0])
            for e in (1, 2, 3)
            for s, (_, host, _) in zip(T.file_epoch_stacks(0, e, sizes, tt.n_batch),
                                       tt.train_groups)]
    assert len(ours) == len(recorded) == 18
    assert sum(idx.shape[0] for idx, _, _ in ours) == 24
    for (ji, jm, jt_), (ti, tm, tt_) in zip(recorded, ours):
        assert ji.dtype == ti.dtype and jm.dtype == tm.dtype
        np.testing.assert_array_equal(ji, ti)
        np.testing.assert_array_equal(jm, tm)
        assert jt_ == tt_


def _jax_step(file_i, solver, u, mask, monkeypatch):
    _, jset, jdata, jprog, jmodel = _jax(1, solver)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    ds = jdata.train.dataset
    fi, local, _ = ds.group_by_file(jdata.train.indices)[file_i]
    host = ds.file_batch(fi, local[:B])
    jbatch = JAttrDict((k, jnp.asarray(v)) for k, v in host.items())
    assert "enc_observations" in jbatch
    calls = []
    if solver.startswith("pallas_"):
        import vihds_tpu.ops.pallas_ode as pk

        name = fused_ode.KINDS["dr"].simulate
        orig = getattr(pk, name)

        def spy(*a, **k):
            calls.append(1)
            k["interpret"] = True
            return orig(*a, **k)

        monkeypatch.setattr(pk, name, spy)

    def loss(params):
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

    value, grads = jax.jit(jax.value_and_grad(loss))(jparams)
    assert bool(calls) == solver.startswith("pallas_")
    return jparams, host, float(value), grads


@pytest.mark.parametrize("file_i,solver", [(5, "pallas_midpoint"), (0, "midpoint")],
                         ids=["kernel-route-T86", "fold-route-T100"])
def test_one_step_on_a_file_group_matches_jax(file_i, solver, monkeypatch):
    rng = np.random.default_rng(11)
    n_theta = _jax(1)[3].n_theta
    u = rng.standard_normal((B, K, n_theta)).astype(np.float32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    jparams, host, j_loss, j_grads = _jax_step(file_i, solver, u, mask, monkeypatch)
    assert host.observations.shape[-1] == (86 if file_i == 5 else 100)
    assert host.enc_observations.shape[-1] == 86

    _, _, _, tprog, tmodel = _port(1, solver)
    tparams = _port_params(jparams)
    for leaf in T.param_leaves(tparams):
        leaf.requires_grad_(True)
    batch = T.batch_tensors(host, slice(None), torch.as_tensor(host.times), "cpu")
    assert "enc_observations" in batch
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
        assert np.isfinite(ref).all() and np.abs(ref).max() > 0
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_multi_eval_matches_jax(monkeypatch):
    """The validation split of split 1 at K=4: the JAX package's
    ``_eval_multi`` against the port's ``evaluate_groups``, the port drawing
    the u that the JAX package's keys give each group's chunk."""
    args, jset, jdata, jprog, jmodel = _jax(1, test_samples=K)
    jt = JTraining(args, jset, jdata, jprog, jmodel)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(3)
    j_merged = jt._eval_multi(jparams, jt.valid_groups, K, key, with_theta=True)

    _, tset, tdata, tprog, tmodel = _port(1)
    tt = T.Training(tset, tdata, tprog, tmodel, device="cpu")
    draws = []
    for (_, host, _), gk in zip(tt.valid_groups, jax.random.split(key, len(tt.valid_groups))):
        n_chunks = math.ceil(host.observations.shape[0] / tt.n_batch)
        for ck in jax.random.split(gk, n_chunks):
            draws.append(np.asarray(jax.random.normal(ck, (tt.n_batch, K, tprog.n_theta),
                                                      jnp.float32)))
    monkeypatch.setattr(tmodel, "sample_u", lambda *a: torch.tensor(draws.pop(0)))
    t_merged = tt.evaluate_groups(_port_params(jparams), tt.valid_groups, K, None, "cpu")
    assert not draws

    n_valid = tdata.n_test
    for name, shape in (("iw_predict_mu", (n_valid, 4, 86)), ("iw_states", (n_valid, 8, 86)),
                        ("theta", (tprog.n_theta, n_valid, K)), ("log_w", (n_valid, K))):
        assert t_merged[name].shape == shape, name
    for name in ("per_item_elbo", "log_w", "q_mu", "q_prec", "theta", "iw_predict_mu",
                 "iw_states", "iw_variance"):
        np.testing.assert_allclose(t_merged[name], np.asarray(j_merged[name]), rtol=1e-5,
                                   err_msg=name)
    # the std is sqrt(E_w[x^2 + 1/prec] - mu^2): where the variance is a small
    # share of mu^2, the weights' float32 rounding (mu agrees to 1e-5) is
    # amplified by the subtraction, so the std is held through the second
    # moment it was computed from
    second = [m["iw_predict_std"].astype(np.float64) ** 2 + m["iw_predict_mu"].astype(np.float64) ** 2
              for m in (t_merged, {k: np.asarray(j_merged[k]) for k in IW})]
    np.testing.assert_allclose(second[0], second[1], rtol=1e-5, err_msg="iw second moment")
    np.testing.assert_allclose(t_merged.elbo, j_merged["elbo"], rtol=1e-5)


def test_xval_artifacts_equal_the_jax_packages(tmp_path):
    """Both packages' ``XvalMerge`` on their own ``merge: false`` split 1,
    given the same seeded fold results, write the same ``xval_*`` files: the
    held-out series' observations snapped onto the shortest grid, the times
    that grid's."""
    from tests.test_torch_xval_cli import XVAL_NAMES, _fold_results
    from vihds_tpu.config import Trainer as JTrainer
    from vihds_tpu.xval import XvalMerge as JXvalMerge
    from vihds_tpu_torch.config import Trainer as TTrainer
    from vihds_tpu_torch.xval import XvalMerge as TXvalMerge

    args, jset, jdata, _, _ = _jax(1, epochs=2, experiment="um")
    targs, tset, tdata, _, _ = _port(1)
    targs.epochs, targs.experiment = 2, "um"
    dirs = {}
    for name, merge_cls, trainer_cls, a, settings, pair in (
            ("port", TXvalMerge, TTrainer, targs, tset, tdata),
            ("jax", JXvalMerge, JTrainer, args, jset, jdata)):
        dirs[name] = str(tmp_path / name)
        os.makedirs(dirs[name])
        settings.trainer = trainer_cls(a, log_dir=dirs[name])
        merge = merge_cls(a, settings)
        merge.add(1, pair, _fold_results(1, pair))
        merge.finalize()
        merge.save()
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"])) == XVAL_NAMES
    for n in XVAL_NAMES:
        a, b = (os.path.join(dirs[k], n) for k in ("port", "jax"))
        if n.endswith(".txt"):
            assert open(a).read() == open(b).read(), n
            continue
        a, b = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
        assert a.shape == b.shape and a.dtype == b.dtype, n
        for x, y in zip(a.ravel(), b.ravel()) if a.dtype == object else [(a, b)]:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=n)
    assert np.load(os.path.join(dirs["port"], "xval_X_obs.npy")).shape == (tdata.n_test, 4, 86)
