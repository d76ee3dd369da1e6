"""The port's training entry point on the CPU: ``run_xval.main`` end to end
on dr_constant_one, dr_constant_precisions, relay_constant_precisions and
degrader_constant_precisions (2 epochs, K=4, the specs' own ``solver:
midpoint``), its artifacts against the JAX package's
``XvalMerge`` given the same fold results, checkpoint and resume, and the
one-line errors for flags whose feature is not ported yet."""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.conftest import spec
from vihds_tpu.xval import XvalMerge as JXvalMerge
from vihds_tpu_torch import run_xval
from vihds_tpu_torch.config import Config, Trainer
from vihds_tpu_torch.data.datasets import build_datasets
from vihds_tpu_torch.results import Results
from vihds_tpu_torch.training import param_leaves
from vihds_tpu_torch.xval import XvalMerge

ARGV = [spec("dr_constant_one.yaml"), "--experiment", "cli", "--epochs", "2", "--test_epoch", "1",
        "--train_samples", "4", "--test_samples", "4", "--seed", "0"]
EPOCH_LINE = re.compile(
    r"^epoch +(\d+) \| train \(iwae-elbo = (\S+), time = \S+, total = \S+\) "
    r"\| val \(iwae-elbo = (\S+), time = \S+, total = \S+\)$", re.M
)


def test_run_xval_main_writes_the_jax_artifact_set(tmp_results, capsys):
    _check_run_xval_artifacts("dr_constant_one.yaml", tmp_results, capsys)


def test_run_xval_main_trains_the_precisions_model(tmp_results, capsys):
    """dr_constant_precisions: the 12-state model with learned precisions,
    on its spec's fold route (``NeuralPrecisions.at_time``)."""
    _check_run_xval_artifacts("dr_constant_precisions.yaml", tmp_results, capsys)


@pytest.mark.parametrize("spec_name", ["relay_constant_precisions.yaml",
                                       "degrader_constant_precisions.yaml"])
def test_run_xval_main_trains_the_relay_and_degrader_models(spec_name, tmp_results, capsys):
    """The 16- and 15-state models (their grids of 99 and 135 points; the
    degrader's three treatments), on their specs' fold route."""
    _check_run_xval_artifacts(spec_name, tmp_results, capsys)


def _check_run_xval_artifacts(spec_name, tmp_results, capsys):
    argv = [spec(spec_name)] + ARGV[1:]
    run_xval.main(argv, device="cpu")
    out = capsys.readouterr().out
    lines = EPOCH_LINE.findall(out)
    assert [int(e) for e, _, _ in lines] == [1, 2]
    assert all(np.isfinite(float(v)) for _, tr, va in lines for v in (tr, va))
    (run_dir,) = [d for d in os.listdir(tmp_results) if d.startswith("cli_")]
    run_dir = os.path.join(tmp_results, run_dir)
    names = set(os.listdir(run_dir))
    assert {"completed.txt", spec_name, ".vihds_cache_1_of_4"} <= names
    cache = Results()
    cache.load(os.path.join(run_dir, ".vihds_cache_1_of_4"))
    assert np.isfinite(cache.iw_predict_mu).all()

    # the JAX package's XvalMerge on the same fold results writes the same
    # files with the same contents
    args = SimpleNamespace(yaml=argv[0], seed=0, folds=4, split=1, heldout=None, epochs=2,
                           experiment="cli")
    settings = Config(args)
    data = build_datasets(args, settings)
    cache.elbo_list = list(np.load(os.path.join(run_dir, "xval_elbo_list.npy"),
                                   allow_pickle=True)[0])
    jdir = os.path.join(tmp_results, "jax")
    os.makedirs(jdir)
    settings.trainer = Trainer(args, log_dir=jdir)
    jm = JXvalMerge(args, settings)
    jm.add(1, data, cache)
    jm.finalize()
    jm.save()
    xval = sorted(n for n in names if n.startswith("xval_"))
    assert len(xval) == 16 and xval == sorted(os.listdir(jdir))
    for n in xval:
        if n.endswith(".txt"):
            assert open(os.path.join(run_dir, n)).read() == open(os.path.join(jdir, n)).read(), n
        else:
            a = np.load(os.path.join(run_dir, n), allow_pickle=True)
            b = np.load(os.path.join(jdir, n), allow_pickle=True)
            assert a.shape == b.shape and a.dtype == b.dtype, n
            for x, y in zip(a.ravel(), b.ravel()) if a.dtype == object else [(a, b)]:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=n)
    # and the port's own loader reads them back
    back = XvalMerge(args, settings)
    back.load(run_dir)
    assert back.iw_predict_mu.shape == (data.n_test, 4, len(data.train.dataset.times))


def _train(argv, tmp_results):
    """Train one split through ``run_xval.run_on_split``; returns the
    ``Training`` that ran."""
    args = run_xval.create_parser(True).parse_args(argv)
    settings = Config(args)
    settings.trainer = Trainer(args, log_dir=str(tmp_results / args.experiment))
    os.makedirs(settings.trainer.tb_log_dir, exist_ok=True)
    return run_xval.run_on_split(args, settings, device="cpu")[2]


def test_resumed_run_ends_where_the_uninterrupted_run_ends(tmp_results):
    base = ARGV[:1] + ["--test_epoch", "2", "--train_samples", "4", "--test_samples", "4",
                       "--seed", "0"]
    whole = _train(base + ["--experiment", "whole", "--epochs", "2"], tmp_results)
    first = _train(base + ["--experiment", "first", "--epochs", "1", "--checkpoint_epoch", "1"],
                   tmp_results)
    ckpt_dir = first.ckpt_dir
    assert os.listdir(ckpt_dir) == ["1.pt"]
    resumed = _train(base + ["--experiment", "resumed", "--epochs", "2", "--resume_from", ckpt_dir],
                     tmp_results)
    assert len(resumed.step_ms) == whole.steps_per_epoch  # only epoch 2 ran
    for a, b in zip(param_leaves(whole.final_params), param_leaves(resumed.final_params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize(
    "flags,item",
    [(["--mesh", "auto"], "parallel/ + parallel/multihost.py"),
     (["--mesh_data", "2"], "parallel/ + parallel/multihost.py"),
     (["--distributed", "auto"], "parallel/ + parallel/multihost.py"),
     (["--vmap_folds"], "xfold.py")],
    ids=lambda v: v if isinstance(v, str) else v[0],
)
def test_unported_flags_stop_with_their_roadmap_item(flags, item, tmp_results):
    with pytest.raises(SystemExit, match='%s is not ported .*ROADMAP queue 1, "%s"'
                       % (flags[0], re.escape(item))):
        run_xval.main([spec("dr_constant_one.yaml")] + flags, device="cpu")
    assert os.listdir(tmp_results) == []
