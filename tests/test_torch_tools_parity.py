"""The port's posterior-parity tools (``vihds_tpu_torch.tools.posterior_parity``
and ``clip_activity``) against the JAX package's scripts under ``tools/``,
on the recorded battery ``reports/posterior_parity_ctrl_unit``.

``compare`` on one directory writes the JAX tool's REPORT.md byte for byte;
``--against`` reads a recorded directory without touching it; the
clip-activity table is the JAX tool's letter for letter; an ``ours`` run
of the port writes the recorded npz's keys, q-site names and shapes.  The
JAX scripts are imported by path (their module level imports only ``os``
and ``sys``), each copy of the recorded files lives under ``tmp_path``."""

import glob
import hashlib
import importlib.util
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

from vihds_tpu_torch.tools import clip_activity, posterior_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDED = os.path.join(REPO, "reports", "posterior_parity_ctrl_unit")


def jax_tool(name):
    """The script ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location("jax_tool_" + name,
                                                  os.path.join(REPO, "tools", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def copy_npz(directory, pattern="*_seed*.npz", rename=None):
    """The recorded battery's npz matching ``pattern`` copied into
    ``directory`` (``rename``: old tag -> new tag)."""
    os.makedirs(directory, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(RECORDED, pattern))):
        name = os.path.basename(path)
        if rename:
            name = name.replace(*rename)
        shutil.copy(path, os.path.join(directory, name))
    return str(directory)


def hashes(directory):
    return {name: hashlib.sha256(open(os.path.join(directory, name), "rb").read()).hexdigest()
            for name in sorted(os.listdir(directory))
            if os.path.isfile(os.path.join(directory, name))}


def read(path):
    with open(path, "rb") as f:
        return f.read()


def test_compare_on_one_directory_is_the_jax_tools_report_byte_for_byte(tmp_path):
    jdir, tdir = copy_npz(tmp_path / "jax"), copy_npz(tmp_path / "port")
    jax_tool("posterior_parity").compare(jdir)
    posterior_parity.main(["compare", tdir])
    want = read(os.path.join(jdir, "REPORT.md"))
    assert read(os.path.join(tdir, "REPORT.md")) == want
    assert b"**61 / 62 site tensors within MC error" in want


@pytest.mark.parametrize("tag", ["reference", "ours"])
def test_compare_against_a_recorded_directory_leaves_it_untouched(tag, tmp_path):
    """The port's side holds copies of the recorded side's own runs: every
    site tensor at z = 0, and the recorded directory's files unchanged."""
    before = hashes(RECORDED)
    port = copy_npz(tmp_path / "port", "%s_seed*.npz" % tag, rename=(tag + "_", "ours_"))
    report = posterior_parity.main(["compare", port, "--against", RECORDED,
                                    "--against_tag", tag])
    assert hashes(RECORDED) == before
    assert os.listdir(port).count("REPORT.md") == 1
    assert read(os.path.join(port, "REPORT.md")).decode() == report
    first = report.splitlines()[0]
    assert posterior_parity.SIDES[tag] in first and RECORDED in first and port in first
    assert "PyTorch port" in first
    assert "**62 / 62 site tensors within MC error (median z <= 3).**" in report
    assert "overall median z = 0.00" in report


def test_compare_against_the_other_side_reads_the_jax_tools_numbers(tmp_path):
    """The port's ``ours_seed*`` against the recorded reference side: the
    table's rows are the JAX tool's rows on the same two sides."""
    jdir = copy_npz(tmp_path / "jax")
    jax_tool("posterior_parity").compare(jdir)
    port = copy_npz(tmp_path / "port", "ours_seed*.npz")
    report = posterior_parity.compare(port, against=RECORDED, against_tag="reference")
    rows = [line for line in report.splitlines() if line.startswith("| ") and "." in line]
    want = [line for line in read(os.path.join(jdir, "REPORT.md")).decode().splitlines()
            if line.startswith("| ") and "." in line]
    assert rows == want and len(rows) == 62 + 4


def test_clip_activity_prints_the_jax_tools_table(tmp_path, capsys):
    d = copy_npz(tmp_path / "runs")
    jax_tool("clip_activity").main(d, "dr_constant_one.yaml")
    want = capsys.readouterr().out
    clip_activity.main([d, "dr_constant_one.yaml"])
    got = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) == 2 + 9 + 12


def test_save_writes_the_jax_tools_npz(tmp_path):
    """One results object through both tools' ``_save``: the same keys, and
    every entry equal, object arrays included."""
    rng = np.random.default_rng(3)
    results = SimpleNamespace(
        q_names=["r.mu", "r.prec", "init_x.value", "aR.mu"],
        q_values=np.array([rng.standard_normal(12).astype(np.float32),
                           rng.random(12).astype(np.float32), np.array([0.002], np.float32),
                           rng.standard_normal(1).astype(np.float32)], dtype=object),
        elbo=np.asarray(512.25, np.float32),
        iw_predict_mu=rng.random((12, 4, 100)).astype(np.float32),
        iw_predict_std=rng.random((12, 4, 100)).astype(np.float32),
    )
    jax_tool("posterior_parity")._save(str(tmp_path / "jax"), "ours", 3, results)
    path = posterior_parity._save(str(tmp_path / "port"), "ours", 3, results)
    assert path == str(tmp_path / "port" / "ours_seed3.npz")
    with np.load(tmp_path / "jax" / "ours_seed3.npz", allow_pickle=True) as want, \
            np.load(path, allow_pickle=True) as got:
        assert got.files == want.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            if want[k].dtype == object:
                for a, b in zip(got[k], want[k]):
                    np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(got[k], want[k])


def test_ours_run_writes_the_recorded_keys_names_and_shapes(tmp_path, monkeypatch):
    """A port ``ours`` run on the CPU at 2 epochs, K = 4: the npz has the
    recorded ``ours_seed0.npz``'s keys, q-site names and per-entry shapes
    (2 epochs leave the ELBO far below -1e4: the run goes under
    ``diverged/``, as the JAX tool's would)."""
    monkeypatch.setenv("VIHDS_REF_TEST_SAMPLES", "4")
    monkeypatch.setenv("VIHDS_REF_TEST_EPOCH", "1")
    monkeypatch.setenv("VIHDS_OURS_Q_INIT", "unit")
    path = posterior_parity.main(["ours", "0", "2", str(tmp_path)], device="cpu",
                                 train_samples=4)
    with np.load(os.path.join(RECORDED, "ours_seed0.npz"), allow_pickle=True) as want, \
            np.load(path, allow_pickle=True) as got:
        assert got.files == want.files
        assert list(got["q_names"]) == list(want["q_names"])
        assert [np.shape(v) for v in got["q_values"]] == [np.shape(v) for v in want["q_values"]]
        assert all(np.asarray(v).dtype == np.float64 for v in got["q_values"])
        for k in ("iw_predict_mu", "iw_predict_std"):
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        elbo = float(got["elbo"])
    assert np.isfinite(elbo)
    diverged = abs(elbo) > posterior_parity.DIVERGED_ELBO
    assert os.path.dirname(path) == (str(tmp_path / "diverged") if diverged else str(tmp_path))
