"""Each of the port's tools (``vihds_tpu_torch.tools``) end to end through
its ``main(argv, device="cpu")`` at a tiny depth, writing under
``tmp_path``; ``xval_plotting`` with the figures' packages hidden; and each
tool module imported in a fresh interpreter without JAX or ``vihds_tpu``.

The checkpoint and the xval artifacts come from one ``run_xval.main`` run
of dr_constant_one (2 epochs, K = 4), shared by the module.  The run and
``xval_plotting`` write no TensorBoard event files here (the writers are
replaced by None, as where tensorboard is not installed): the first
writer of a process imports tensorflow, ~15 s, and the event files are
held by tests/test_torch_summaries.py and tests/test_torch_figures.py."""

import glob
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import spec
from vihds_tpu_torch import run_xval, training, xval
from vihds_tpu_torch.tools import (ar_mu_ground_truth, clip_activity, icml_site_mechanism,
                                   posterior_parity, refine_demo, xval_plotting)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("posterior_parity", "clip_activity", "refine_demo", "ar_mu_ground_truth",
         "icml_site_mechanism", "xval_plotting")
#: a tiny training regime
TINY = dict(train_samples=4, test_samples=4)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A trained dr_constant_one run directory with its checkpoints."""
    results = tmp_path_factory.mktemp("results")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("INFERENCE_RESULTS_DIR", str(results))
        mp.setattr(training, "summary_writer", lambda path: None)
        run_xval.main([spec("dr_constant_one.yaml"), "--experiment", "tools", "--epochs", "2",
                       "--test_epoch", "1", "--train_samples", "4", "--test_samples", "4",
                       "--seed", "0", "--checkpoint_epoch", "1"], device="cpu")
    (name,) = os.listdir(results)
    return str(results / name)


def test_posterior_parity_ours_then_compare(tmp_path, monkeypatch):
    monkeypatch.setenv("VIHDS_REF_TEST_SAMPLES", "4")
    path = posterior_parity.main(["ours", "1", "1", str(tmp_path)], device="cpu",
                                 train_samples=4)
    assert os.path.exists(path) and path.startswith(str(tmp_path))
    # compare over the recorded battery's ours side as the port's runs
    port = tmp_path / "port"
    port.mkdir()
    recorded = os.path.join(REPO, "reports", "posterior_parity_ctrl_unit")
    for f in glob.glob(os.path.join(recorded, "ours_seed*.npz")):
        shutil.copy(f, port)
    report = posterior_parity.main(["compare", str(port), "dr_constant_one", "--against",
                                    recorded, "--against_tag", "ours"])
    assert (port / "REPORT.md").read_text() == report


def test_clip_activity_on_a_directory(tmp_path, capsys):
    for f in glob.glob(os.path.join(REPO, "reports", "posterior_parity_ctrl_unit",
                                    "reference_seed[01].npz")):
        shutil.copy(f, tmp_path)
    clip_activity.main([str(tmp_path)], device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "| run | mean escaped q-mass | max escaped q-mass | worst site |"
    assert [line.split(" | ")[0] for line in lines[2:]] == ["| reference_seed0",
                                                           "| reference_seed1"]


def test_refine_demo_on_a_checkpoint(run_dir, capsys):
    shown = refine_demo.main([os.path.join(run_dir, "checkpoints_1_of_4"),
                              "specs/dr_constant_one.yaml", "2"], device="cpu", n_temps=1,
                             n_moves=1, n_steps=2)
    out = capsys.readouterr().out
    assert "restored params from epoch 2" in out
    assert "per-datapoint bounds (first 12 validation series):" in out
    assert all(math.isfinite(v) for v in shown.values())
    with pytest.raises(SystemExit, match="no checkpoint under"):
        refine_demo.main([run_dir, "specs/dr_constant_one.yaml", "4"], device="cpu")


def test_ar_mu_ground_truth_run_and_report(tmp_path, monkeypatch):
    monkeypatch.setenv("VIHDS_ARMU_EPOCHS", "1")
    monkeypatch.setenv("VIHDS_ARMU_LEAPFROG", "2")
    path = ar_mu_ground_truth.main(["run", "3", str(tmp_path), "4"], device="cpu", n_chains=2,
                                   **TINY)
    assert path == str(tmp_path / "seed3.npz")
    with np.load(path) as z:
        recorded = np.load(os.path.join(REPO, "reports", "ar_mu_ground_truth_r5", "seed0.npz"))
        assert set(recorded.files) <= set(z.files)
        assert z["aR_ens_mu"].shape == (4,) and z["aR_series_mu"].shape == (36,)
    report = ar_mu_ground_truth.main(["report", str(tmp_path)])
    assert "| 3 | aR |" in open(report).read()


def test_icml_site_mechanism_ridge_and_drift(tmp_path, monkeypatch):
    """On dr_constant_one, which has every site of ``BLOCK`` (one training
    step an epoch against dr_constant_icml's seven)."""
    monkeypatch.setattr(icml_site_mechanism, "SPEC", "dr_constant_one.yaml")
    path = icml_site_mechanism.main(["ridge", "0", str(tmp_path)], device="cpu", epochs=1,
                                    n_chains=2, n_steps=2, n_leapfrog=1, **TINY)
    with np.load(path) as z:
        P = len(icml_site_mechanism.BLOCK)
        assert z["mean_corr"].shape == (P, P) and np.isfinite(z["corr"]).all()
        np.testing.assert_allclose(np.diagonal(z["mean_corr"]), 1.0, rtol=1e-5)
    path = icml_site_mechanism.main(["drift", "0", str(tmp_path), "1"], device="cpu", **TINY)
    with np.load(path) as z:
        assert sorted(z.files) == ["KGS_81_q_mu", "KGS_81_q_prec", "aYFP_q_mu", "aYFP_q_prec",
                                   "epochs"]
        assert list(z["epochs"]) == [1]
    with pytest.raises(SystemExit, match="ridge|drift"):
        icml_site_mechanism.main(["other"], device="cpu")


def test_xval_plotting_writes_the_figures(run_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(xval, "summary_writer", lambda path: None)
    location = str(tmp_path / "run")
    shutil.copytree(run_dir, location)
    xval_plotting.main([location, spec("dr_constant_one.yaml")])
    pngs = {f[:-4] for f in os.listdir(location) if f.endswith(".png")}
    assert {"xval_fit", "xval_treatments", "xval_species", "xval_global_parameters",
            "xval_variable_parameters", "xval_summary_Pcat_Y81C76",
            "xval_individual_Pcat_Y81C76"} <= pngs
    assert all(os.path.exists(os.path.join(location, f + ".pdf")) for f in pngs)


@pytest.mark.parametrize("blocked", ["matplotlib", "seaborn"])
def test_xval_plotting_stops_naming_a_missing_package(blocked, run_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, blocked, None)
    before = sorted(os.listdir(run_dir))
    with pytest.raises(SystemExit) as e:
        xval_plotting.main([run_dir, spec("dr_constant_one.yaml")])
    assert str(e.value) == "--figures needs the %s package, which is not installed" % blocked
    assert sorted(os.listdir(run_dir)) == before


def test_tools_import_no_jax():
    """A fresh interpreter that imports every tool module has neither jax
    nor vihds_tpu in sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import importlib\n"
        "for name in %r:\n"
        "    importlib.import_module('vihds_tpu_torch.tools.' + name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'vihds_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n" % (REPO, TOOLS)
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "clean" in r.stdout


def test_a_tool_runs_as_a_module(tmp_path):
    """``python -m vihds_tpu_torch.tools.<name>`` with the JAX tool's
    positional arguments (clip_activity: nothing runs on a device)."""
    shutil.copy(os.path.join(REPO, "reports", "posterior_parity_ctrl_unit", "ours_seed0.npz"),
                tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "vihds_tpu_torch.tools.clip_activity",
                        str(tmp_path), "dr_constant_one.yaml"], capture_output=True, text=True,
                       timeout=300, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.splitlines()[2].startswith("| ours_seed0 | ")
