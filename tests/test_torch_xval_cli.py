"""The port's k-fold cross-validation ``call_run_xval`` on the CPU: a 2-fold run of
dr_constant_one end to end, and the merged ``xval_*`` artifacts against the
JAX package's when both are handed the same fold results."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from tests.conftest import spec
from vihds_tpu import call_run_xval as j_call_run_xval
from vihds_tpu.config import Config as JConfig, Trainer as JTrainer
from vihds_tpu.data.datasets import build_datasets as j_build
from vihds_tpu.xval import XvalMerge as JXvalMerge
from vihds_tpu_torch import call_run_xval
from vihds_tpu_torch.config import Config, Trainer
from vihds_tpu_torch.data.datasets import build_datasets

SPEC = spec("dr_constant_one.yaml")
XVAL_NAMES = sorted(
    ["xval_%s.npy" % n for n in ("elbo", "elbo_list", "q_values", "theta", "iw_predict_mu",
                                 "iw_predict_std", "iw_states", "devices", "treatments", "X_obs",
                                 "chunk_sizes", "ids", "times")]
    + ["xval_%s.txt" % n for n in ("q_names", "device_names", "names")]
)


def test_two_folds_write_the_merged_artifact_set(tmp_results, capsys, monkeypatch):
    """``main`` trains folds 1 and 2 in turn (one epoch each, 4 samples) and
    writes each fold's best-validation cache, the 16 ``xval_*`` files of the
    JAX package (which ``XvalMerge.save`` names in both packages) and the
    completed marker; the merge holds both folds' held-out series.  It hands
    the merge to the figures once (recorded here; the figures themselves are
    held in tests/test_torch_figures.py)."""
    drawn = []
    monkeypatch.setattr(call_run_xval, "write_figures", drawn.append)
    merge = call_run_xval.main(
        [SPEC, "--experiment", "xv", "--epochs", "1", "--test_epoch", "1", "--folds", "2",
         "--train_samples", "4", "--test_samples", "4", "--seed", "0"], device="cpu")
    out = capsys.readouterr().out
    assert "FOLD 1 of 2" in out and "FOLD 2 of 2" in out and "Completed" in out
    (run_dir,) = [os.path.join(tmp_results, d) for d in os.listdir(tmp_results)
                  if d.startswith("xv_")]
    names = set(os.listdir(run_dir))
    assert {"completed.txt", ".vihds_cache_1_of_2", ".vihds_cache_2_of_2"} <= names
    assert sorted(n for n in names if n.startswith("xval_")) == XVAL_NAMES
    assert open(os.path.join(run_dir, "completed.txt")).read() == "xv"
    assert len(merge.elbo) == 2 and np.isfinite(merge.elbo).all()
    assert len(merge.chunk_sizes) == 2
    assert drawn == [merge]
    ids = np.load(os.path.join(run_dir, "xval_ids.npy"), allow_pickle=True)
    assert len(ids) == len(set(ids.tolist())) == merge.iw_predict_mu.shape[0]


def _fold_results(split, data_pair, n_theta=7, K=3):
    """Seeded stand-ins for one fold's best-validation Results."""
    rng = np.random.default_rng(100 + split)
    n, T = data_pair.n_test, len(data_pair.train.dataset.times)
    q_names = ["q%d" % i for i in range(n_theta)]
    return SimpleNamespace(
        q_names=q_names,
        species_names=["OD", "RFP", "YFP", "CFP", "F530", "F480", "LuxR", "LasR"],
        elbo=float(rng.standard_normal()),
        elbo_list=list(rng.standard_normal(3 + split)),
        q_values=[rng.standard_normal(n).astype(np.float32) for _ in q_names],
        theta=rng.standard_normal((n_theta, n, K)).astype(np.float32),
        iw_predict_mu=rng.standard_normal((n, 4, T)).astype(np.float32),
        iw_predict_std=np.abs(rng.standard_normal((n, 4, T))).astype(np.float32),
        iw_states=rng.standard_normal((n, 8, T)).astype(np.float32),
    )


@pytest.mark.parametrize("folds", [2, 4])
def test_merged_artifacts_equal_the_jax_packages(tmp_results, monkeypatch, folds):
    """Both packages' ``call_run_xval.execute`` with ``run_on_split`` replaced by the same
    seeded fold results (on each package's own folds of the spec) write the
    same ``xval_*`` files with the same contents.  Both packages' figures and
    TensorBoard writer are switched off for the comparison (the figures are
    held in tests/test_torch_figures.py)."""
    argv = [SPEC, "--experiment", "eq", "--epochs", "2", "--folds", str(folds), "--seed", "0"]
    dirs = {}

    def fake(build, triple):
        def run_on_split(args, settings, split=None, **kw):
            args.split, args.heldout = split, None
            pair = build(args, settings)
            res = _fold_results(split, pair)
            return (pair, res, None) if triple else (pair, res)

        return run_on_split

    from vihds_tpu_torch import run_xval

    args = run_xval.create_parser(False).parse_args(argv)
    settings = Config(args)
    dirs["port"] = str(tmp_results / "port")
    settings.trainer = Trainer(args, log_dir=dirs["port"])
    os.makedirs(dirs["port"])
    monkeypatch.setattr(call_run_xval, "run_on_split", fake(build_datasets, True))
    monkeypatch.setattr(call_run_xval, "write_figures", lambda merge: None)
    call_run_xval.execute(args, settings, device="cpu")

    jargs = j_call_run_xval.create_parser(False).parse_args(argv)
    jset = JConfig(jargs)
    dirs["jax"] = str(tmp_results / "jax")
    jset.trainer = JTrainer(jargs, log_dir=dirs["jax"])
    os.makedirs(dirs["jax"])
    monkeypatch.setattr(j_call_run_xval, "run_on_split", fake(j_build, False))
    for name in ("make_writer", "make_images", "close_writer"):
        monkeypatch.setattr(JXvalMerge, name, lambda self: None)
    j_call_run_xval.execute(jargs, jset)

    names = {k: sorted(os.listdir(d)) for k, d in dirs.items()}
    assert names["port"] == names["jax"] == sorted(XVAL_NAMES + ["completed.txt"])
    for n in XVAL_NAMES + ["completed.txt"]:
        a, b = (os.path.join(dirs[k], n) for k in ("port", "jax"))
        if not n.endswith(".npy"):
            assert open(a).read() == open(b).read(), n
            continue
        a, b = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
        assert a.shape == b.shape and a.dtype == b.dtype, n
        for x, y in zip(a.ravel(), b.ravel()) if a.dtype == object else [(a, b)]:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=n)
    assert np.load(os.path.join(dirs["port"], "xval_elbo.npy")).shape == (folds,)


def test_vmap_folds_trains_every_fold_in_one_batched_step(tmp_results, capsys, monkeypatch):
    """``--vmap_folds`` trains both folds in one batched run (no fall-back
    line, the JAX package's per-fold epoch lines) and writes what the
    sequential driver writes: each fold's cache, the 16 ``xval_*`` files and
    the completed marker.  Its numbers against the sequential driver's are
    held in tests/test_torch_xfold.py."""
    monkeypatch.setattr(call_run_xval, "write_figures", lambda merge: None)
    merge = call_run_xval.main(
        [SPEC, "--experiment", "xv", "--epochs", "1", "--test_epoch", "1", "--folds", "2",
         "--train_samples", "4", "--test_samples", "4", "--seed", "0", "--vmap_folds"],
        device="cpu")
    out = capsys.readouterr().out
    assert "falling back" not in out and "FOLD 1 of 2" not in out
    assert "Training: 2 folds vmapped (one batched program)" in out
    assert "epoch    1 | fold 1 | train" in out and "epoch    1 | fold 2 | train" in out
    run_dir = merge.trainer.tb_log_dir
    names = os.listdir(run_dir)
    assert {".vihds_cache_1_of_2", ".vihds_cache_2_of_2", "completed.txt"} <= set(names)
    assert sorted(n for n in names if n.startswith("xval_")) == XVAL_NAMES
