"""Serving from a checkpoint through the port's CLI on the CPU:
``run_xval.main --checkpoint_epoch 1`` on dr_constant_one, then
``predict.main --checkpoint``; the npz against an in-memory ``predict`` on
the restored params (bit for bit: the same computation from the same
generator seed), the checkpoint's epoch in it, and the one-line errors for a
missing or empty checkpoint directory.  Also a checkpoint of a ``merge:
false`` model served on the encoder's grid.  ``--figures`` is driven in
tests/test_torch_figures.py."""

import os

import numpy as np
import pytest
import torch

from tests.conftest import spec
from vihds_tpu_torch import checkpoint as ckpt
from vihds_tpu_torch import predict as P
from vihds_tpu_torch import run_xval
from vihds_tpu_torch.training import param_leaves

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
SPEC = spec("dr_constant_one.yaml")
CSV = os.path.join(DATA, "proc141006.csv")


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """One epoch of dr_constant_one through ``run_xval.main`` with
    ``--checkpoint_epoch 1``; its checkpoints directory."""
    results = tmp_path_factory.mktemp("results")
    mp = pytest.MonkeyPatch()
    mp.setenv("INFERENCE_RESULTS_DIR", str(results))
    try:
        run_xval.main([SPEC, "--experiment", "serve", "--epochs", "1", "--test_epoch", "1",
                       "--train_samples", "4", "--test_samples", "4", "--seed", "0",
                       "--checkpoint_epoch", "1"], device="cpu")
    finally:
        mp.undo()
    (run_dir,) = os.listdir(results)
    directory = os.path.join(results, run_dir, "checkpoints_1_of_4")
    assert os.listdir(directory) == ["1.pt"]
    return directory


def test_predict_main_serves_the_checkpoint(ckpt_dir, tmp_path, capsys):
    out_path = str(tmp_path / "out.npz")
    out = P.main([SPEC, "--checkpoint", ckpt_dir, "--data", CSV, "--output", out_path,
                  "--test_samples", "6", "--treatments", "C6=25000;C12=0"], device="cpu")
    assert "checkpoint epoch 1" in capsys.readouterr().out
    z = np.load(out_path, allow_pickle=True)
    assert int(z["checkpoint_epoch"]) == out.epoch == 1
    B = z["observations"].shape[0]
    assert z["iw_predict_mu"].shape == (B, 4, 100) and np.isfinite(z["iw_predict_mu"]).all()
    assert np.isfinite(z["cf0_iw_predict_mu"]).all()

    epoch, restored = P.restore_params(ckpt_dir)
    assert epoch == 1
    assert all(leaf.device.type == "cpu" and torch.isfinite(leaf).all()
               for leaf in param_leaves(restored))
    args = P.create_parser().parse_args([SPEC, "--data", CSV, "--test_samples", "6",
                                         "--treatments", "C6=25000;C12=0"])
    mem = P.predict(args, params=restored, device="cpu")
    assert mem.epoch == -1
    for name in ("iw_predict_mu", "iw_predict_std", "iw_states", "iw_variance", "per_item_elbo",
                 "q_mu", "q_prec"):
        np.testing.assert_array_equal(z[name], mem.merged[name], err_msg=name)
    np.testing.assert_array_equal(z["cf0_iw_predict_mu"], mem.counterfactuals[0].iw_predict_mu)


@pytest.mark.parametrize("kind", ["missing", "empty"])
def test_no_checkpoint_stops_and_creates_nothing(kind, tmp_path):
    target = tmp_path / "ckpts" / "run"
    if kind == "empty":
        target.mkdir(parents=True)
    before = sorted(p for p in tmp_path.rglob("*"))
    out_path = tmp_path / "out.npz"
    with pytest.raises(SystemExit, match="No checkpoint found under %s" % target):
        P.main([SPEC, "--checkpoint", str(target), "--data", CSV, "--output", str(out_path)],
               device="cpu")
    assert sorted(p for p in tmp_path.rglob("*")) == before
    assert not out_path.exists()


def test_cli_needs_a_checkpoint():
    with pytest.raises(SystemExit):
        P.main([SPEC, "--data", CSV], device="cpu")


def test_unmerged_checkpoint_serves_on_the_encoder_grid(tmp_path):
    """A checkpoint of a ``merge: false`` model (its seeded initial params,
    saved as training saves them): the new CSV lands on the shortest grid,
    which the encoder reads as ``enc_observations``."""
    from types import SimpleNamespace

    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters
    from vihds_tpu_torch.vae import VAE

    spec_path = spec("dr_constant_icml_unmerged.yaml")
    args = SimpleNamespace(yaml=spec_path, seed=0, folds=4, split=1, heldout=None)
    settings = Config(args)
    data = build_datasets(args, settings)
    model = VAE(settings, data, ParamProgram(parse_parameters(settings.params)))
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    ckpt.save(str(tmp_path / "ck"), 3, {"params": params, "epoch": 3})
    out = P.main([spec_path, "--checkpoint", str(tmp_path / "ck"), "--data",
                  os.path.join(DATA, "proc141021.csv"), "--test_samples", "3",
                  "--output", str(tmp_path / "out.npz")], device="cpu")
    assert out.epoch == 3
    np.testing.assert_array_equal(out.host.enc_observations, out.host.observations)
    B = out.host.observations.shape[0]
    assert out.merged.iw_predict_mu.shape == (B, 4, 86)
    assert np.isfinite(out.merged.iw_predict_mu).all()
    assert int(np.load(str(tmp_path / "out.npz"))["checkpoint_epoch"]) == 3
