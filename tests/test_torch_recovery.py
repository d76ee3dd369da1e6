"""The port's recovery study (``vihds_tpu_torch.recovery_study``) against
the reference tool ``tools/recovery_study.py`` on the CPU.

Its numpy helpers equal the tool's on seeded traces; its summary gives back,
bit for bit, the headline the tool recorded for its two runs under
``reports/``; a tiny whole study (2 epochs, 6 series, the calibration cut to
20 steps) writes the tool's files; and the HMC stages, which wait for
``refine.py``, stop the study before it starts."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from tests.conftest import spec
from vihds_tpu.config import Config as JConfig
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu_torch import recovery_study as rs
from vihds_tpu_torch import simulate as tsim
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: what tools/recovery_study.py writes into recovery.npz with the HMC
#: stages off (its median_local_corr only where a local site varies)
RECOVERY_KEYS = {"q_mu", "q_prec", "truth_theta", "theta_names", "iw_predict_mu",
                 "iw_predict_std", "observations", "median_abs_z", "coverage95",
                 "predictive_coverage95", "median_local_corr", "val_elbo", "epochs", "seed",
                 "sigma_scale", "n_series"}
HEADLINE = ("median_abs_z", "coverage95", "predictive_coverage95", "median_local_corr")


@pytest.fixture(scope="module")
def tool():
    """tools/recovery_study.py, imported as a file."""
    loader = importlib.util.spec_from_file_location(
        "recovery_study_tool", os.path.join(REPO, "tools", "recovery_study.py"))
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module


def _programs(spec_name):
    args = tsim.create_parser().parse_args([spec(spec_name), "--output_dir", "unused"])
    return (JProgram(j_parse(JConfig(args).params)), TProgram(t_parse(TConfig(args).params)))


def test_mixing_helpers_equal_the_tool(tool):
    rng = np.random.default_rng(11)
    # AR(1) chains: autocorrelated, some coordinates stuck apart
    traces = []
    for phi, shift in ((0.0, 0.0), (0.6, 0.0), (0.95, 0.5), (0.3, 3.0)):
        x = np.zeros((60, 4))
        for s in range(1, 60):
            x[s] = phi * x[s - 1] + rng.standard_normal(4)
        traces.append(x + shift * np.arange(4)[None, :])
    traces.append(np.ones((60, 4)))  # no variance at all
    traces.append(rng.standard_normal((3, 4)))  # too short to split
    for x in traces:
        assert str(rs._ess_rhat_coord(x)) == str(tool._ess_rhat_coord(x))
    assert rs.mixing_summary(traces) == tool.mixing_summary(traces)
    assert rs.mixing_summary([traces[-1]]) is tool.mixing_summary([traces[-1]]) is None
    z, z0 = rng.standard_normal((2, 5, 8, 6))
    prec = np.exp(rng.standard_normal(6)).astype(np.float32)
    cols = np.array([0, 2, 5])
    assert rs.rms_displacement(z, z0, prec, cols) == tool.rms_displacement(z, z0, prec, cols)


def test_site_comparisons_equal_the_tool(tool):
    jprog, tprog = _programs("dr_constant_one.yaml")
    rng = np.random.default_rng(12)
    L, n = 9, tprog.n_theta
    q_mu = rng.standard_normal((L, n)).astype(np.float32)
    q_prec = np.exp(rng.standard_normal((L, n))).astype(np.float32)
    truth = np.exp(rng.standard_normal((L, n))).astype(np.float32)
    truth[:, tprog.global_slice] = truth[0:1, tprog.global_slice]
    got = rs.site_comparisons(tprog, q_mu, q_prec, truth)
    want = tool.site_comparisons(jprog, q_mu, q_prec, truth)
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert {r[1] for r in got} == {"local", "global_cond", "global"}
    for (_, _, zg, cg), (_, _, zw, cw) in zip(got, want):
        np.testing.assert_array_equal(zg, zw)
        assert cg == cw


@pytest.mark.parametrize("report, spec_name", [
    ("recovery_study", "dr_constant_one.yaml"),
    ("recovery_precisions", "dr_constant_precisions.yaml"),
])
def test_headline_of_the_recorded_runs(report, spec_name):
    """The port's summary of a recorded recovery.npz equals the headline
    the tool recorded in it, exactly."""
    rec = np.load(os.path.join(REPO, "reports", report, "recovery.npz"), allow_pickle=True)
    _, tprog = _programs(spec_name)
    assert list(rec["theta_names"]) == tprog.names
    _, summary = rs.headline(tprog, rec)
    for k in HEADLINE:
        assert summary[k] == float(rec[k]), k


@pytest.fixture(scope="module")
def tiny_study(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("study")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsim, "calibrate_shared_center",
                   functools.partial(tsim.calibrate_shared_center, steps=20))
        mp.setenv("INFERENCE_RESULTS_DIR", str(outdir / "results"))
        summary = rs.main(["--epochs", "2", "--test_epoch", "2", "--train_samples", "4",
                           "--test_samples", "8", "--n_per_device", "6", "--refine_chains", "0",
                           "--pooled_chains", "0", "--outdir", str(outdir)], device="cpu")
    return outdir, summary


def test_tiny_study_writes_the_tools_files(tiny_study):
    outdir, summary = tiny_study
    rec = np.load(os.path.join(outdir, "recovery.npz"), allow_pickle=True)
    assert set(rec.files) == RECOVERY_KEYS
    assert rec["q_mu"].shape == rec["truth_theta"].shape == (6, 37)
    assert rec["iw_predict_mu"].shape == rec["observations"].shape == (6, 4, 100)
    assert np.isfinite(rec["val_elbo"]) and np.isfinite(summary["val_elbo"])
    assert int(rec["n_series"]) == 6 and int(rec["epochs"]) == 2
    for k in HEADLINE:
        assert float(rec[k]) == summary[k] and np.isfinite(summary[k])
    report = open(os.path.join(outdir, "REPORT.md")).read()
    assert report.startswith("# Parameter-recovery study (simulate -> infer -> compare)")
    for heading in ("## Headline", "## Per-site", "## Reading the table"):
        assert heading in report
    assert "| median abs z (truth under recovered posterior) | %.2f |" % summary[
        "median_abs_z"] in report
    assert "python -m vihds_tpu_torch.recovery_study --epochs 2 --seed 0" in report
    for name in ("synthetic.csv", "synthetic.yaml", "synthetic_truth.npz"):
        assert os.path.exists(os.path.join(outdir, name))


@pytest.mark.parametrize("flag", ["--refine_chains", "--pooled_chains"])
def test_hmc_stages_stop_before_any_stage(flag, tmp_path, capsys):
    outdir = tmp_path / "study"
    argv = ["--refine_chains", "0", "--pooled_chains", "0", "--outdir", str(outdir), flag, "8"]
    with pytest.raises(SystemExit, match=r'ROADMAP queue 1, "refine.py"\); pass '
                                          r'--refine_chains 0 --pooled_chains 0'):
        rs.main(argv, device="cpu")
    assert not outdir.exists()
    assert "=== 1/3" not in capsys.readouterr().out
    # the defaults stay the tool's: the study asks for both stages
    assert rs.parse([]).refine_chains == 64 and rs.parse([]).pooled_chains == 32


def test_study_needs_a_card_unless_the_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is usable")
    outdir = tmp_path / "study"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rs.main(["--refine_chains", "0", "--pooled_chains", "0", "--outdir", str(outdir)])
    assert not outdir.exists()


def test_recorded_simulation_scores_again(tmp_path, monkeypatch):
    """Stages 2 and 3 alone (``train_and_score``) on the JAX package's
    recorded simulation under reports/recovery_study, its spec's files
    pointed at the recorded CSV: the study scores the recorded truth on the
    recorded observations."""
    import yaml

    recorded = os.path.join(REPO, "reports", "recovery_study")
    with open(os.path.join(recorded, "synthetic.yaml")) as f:
        config = yaml.safe_load(f)
    config["data"]["files"] = [os.path.join(recorded, "synthetic.csv")]
    spec_path = str(tmp_path / "synthetic.yaml")
    with open(spec_path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
    monkeypatch.setenv("INFERENCE_RESULTS_DIR", str(tmp_path / "results"))
    truth_path = os.path.join(recorded, "synthetic_truth.npz")
    args = rs.parse(["--epochs", "2", "--test_epoch", "2", "--train_samples", "4",
                     "--test_samples", "8", "--refine_chains", "0", "--pooled_chains", "0",
                     "--outdir", str(tmp_path / "study")])
    summary = rs.train_and_score(args, spec_path, truth_path, "cpu")
    rec = np.load(str(tmp_path / "study" / "recovery.npz"), allow_pickle=True)
    truth = np.load(truth_path, allow_pickle=True)
    reference = np.load(os.path.join(recorded, "recovery.npz"), allow_pickle=True)
    assert set(rec.files) == RECOVERY_KEYS
    np.testing.assert_array_equal(rec["truth_theta"], truth["theta_clipped"])
    np.testing.assert_array_equal(rec["truth_theta"], reference["truth_theta"])
    np.testing.assert_allclose(rec["observations"], truth["observations"], rtol=2e-6, atol=2e-6)
    assert int(rec["n_series"]) == 48
    for k in HEADLINE + ("val_elbo",):
        assert np.isfinite(summary[k]), k
    assert os.path.exists(str(tmp_path / "study" / "REPORT.md"))
