"""The port's TensorBoard scalars on the CPU against the JAX package's, and
its runs without the optional packages.

* ``utils.variable_summaries`` and ``training.update_summaries`` in both
  packages on the same merged evaluation arrays (dr_constant_one and
  dr_constant_precisions, ``plot_histograms`` off and on) into a recording
  writer: the (tag, step, value) lists must be equal, values to rtol 1e-6.
* A whole CPU run: ``run_xval.main --epochs 2 --test_epoch 1`` of both
  packages writes ``train_1_of_4/`` and ``valid_1_of_4/`` event files with
  the same scalar and figure tags at the same steps (the two packages draw
  different random streams, so whole runs are compared by tags and steps).
* ``Config`` clamps ``test_epoch`` and ``plot_epoch`` to ``epochs`` as the
  JAX package's does.
* With tensorboard, matplotlib and seaborn blocked in a fresh interpreter,
  every module of the port imports, a CPU run says once that the summaries
  are off and still writes its ``xval_*`` set, and ``--figures`` stops before
  training, naming the missing package; no module of the port imports any of
  the three when it loads.
"""

import math
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from tests.conftest import spec
from vihds_tpu import run_xval as j_run_xval
from vihds_tpu.config import Config as JConfig
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu.training import update_summaries as j_update_summaries
from vihds_tpu.utils import variable_summaries as j_variable_summaries
from vihds_tpu_torch import run_xval
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.training import update_summaries
from vihds_tpu_torch.utils import variable_summaries
from vihds_tpu_torch.utils.attrdict import AttrDict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class RecordingWriter:
    """The two SummaryWriter methods the summaries call, recorded."""

    def __init__(self):
        self.records = []

    def add_scalar(self, tag, value, step):
        self.records.append((tag, step, np.asarray(value, dtype=np.float64)))

    def add_histogram(self, tag, values, step):
        self.records.append((tag, step, np.asarray(values, dtype=np.float64)))


def _assert_same_records(a, b):
    assert [(t, s) for t, s, _ in a] == [(t, s) for t, s, _ in b]
    assert len(a) > 0
    for (tag, _, x), (_, _, y) in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=1e-6, err_msg=tag)


def _merged(program, n_signals, seed, B=5, K=7):
    """Merged evaluation arrays as ``Training.evaluate`` returns them."""
    rng = np.random.default_rng(seed)
    log_p_by_species = rng.normal(-50.0, 10.0, (B, K, n_signals)).astype(np.float32)
    log_p = rng.normal(-5.0, 1.0, (B, K)).astype(np.float32)
    log_q = rng.normal(-3.0, 1.0, (B, K)).astype(np.float32)
    log_p_obs = log_p_by_species.sum(axis=2)
    log_w = log_p_obs + log_p - log_q
    m = log_w.max(axis=1, keepdims=True)
    per_item = (m[:, 0] + np.log(np.exp(log_w - m).sum(axis=1)) - math.log(K)).astype(np.float32)
    return AttrDict(
        q_mu=rng.normal(size=(B, program.n_theta)).astype(np.float32),
        q_prec=np.exp(rng.normal(size=(B, program.n_theta))).astype(np.float32),
        log_w=log_w, log_p_obs=log_p_obs, log_p=log_p, log_q=log_q,
        log_p_by_species=log_p_by_species, per_item_elbo=per_item,
        elbo=float(per_item.mean()),
    )


@pytest.mark.parametrize("plot_histograms", [False, True], ids=["scalars", "histograms"])
@pytest.mark.parametrize("spec_name", ["dr_constant_one.yaml", "dr_constant_precisions.yaml"])
def test_update_summaries_writes_the_jax_packages_records(spec_name, plot_histograms):
    args = SimpleNamespace(yaml=spec(spec_name), seed=0, epochs=2, test_epoch=1, plot_epoch=0)
    jset, tset = JConfig(args), TConfig(args)
    jset.params.plot_histograms = tset.params.plot_histograms = plot_histograms
    jprog, tprog = JProgram(j_parse(jset.params)), TProgram(t_parse(tset.params))
    assert jprog.names == tprog.names
    merged = _merged(tprog, len(tset.data.signals), seed=len(spec_name))
    jw, tw = RecordingWriter(), RecordingWriter()
    for epoch in (1, 2):
        j_update_summaries(jw, epoch, merged, jprog, jset)
        update_summaries(tw, epoch, merged, tprog, tset)
    _assert_same_records(tw.records, jw.records)
    assert any(t == "ELBO/elbo" for t, _, _ in tw.records)
    assert any(t.endswith("/histogram") for t, _, _ in tw.records) == plot_histograms


def test_variable_summaries_write_the_jax_packages_records():
    var = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    jw, tw = RecordingWriter(), RecordingWriter()
    for fn, w in ((j_variable_summaries, jw), (variable_summaries, tw)):
        fn(w, 3, var, "x", plot_histograms=True)
        fn(None, 3, var, "x")
    _assert_same_records(tw.records, jw.records)


def _event_tags(directory):
    acc = EventAccumulator(directory, size_guidance={"images": 0, "scalars": 0})
    acc.Reload()
    tags = acc.Tags()
    return ({t: [e.step for e in acc.Scalars(t)] for t in tags["scalars"]},
            {t: [e.step for e in acc.Images(t)] for t in tags["images"]})


def test_whole_run_writes_the_jax_packages_event_tags(tmp_path, monkeypatch):
    argv = [spec("dr_constant_one.yaml"), "--experiment", "tb", "--epochs", "2", "--test_epoch",
            "1", "--train_samples", "4", "--test_samples", "4", "--seed", "0"]
    tags = {}
    for package, main in (("jax", j_run_xval.main), ("port", None)):
        results = tmp_path / package
        monkeypatch.setenv("INFERENCE_RESULTS_DIR", str(results))
        if main is None:
            run_xval.main(argv, device="cpu")
        else:
            main(argv)
        (run_dir,) = os.listdir(results)
        tags[package] = {split: _event_tags(str(results / run_dir / split))
                         for split in ("train_1_of_4", "valid_1_of_4")}
    assert tags["port"] == tags["jax"]
    scalars, images = tags["port"]["valid_1_of_4"]
    assert scalars["ELBO/elbo"] == [1, 2]
    # plot_epoch defaults to 100, clamped to the 2 epochs
    assert images == {"Summary": [2]}


@pytest.mark.parametrize("epochs", [1, 2, 150])
def test_config_clamps_test_and_plot_epoch_as_the_jax_package(epochs):
    got = []
    for config, parser in ((JConfig, j_run_xval.create_parser),
                           (TConfig, run_xval.create_parser)):
        args = parser(True).parse_args([spec("dr_constant_one.yaml"), "--epochs", str(epochs),
                                        "--test_epoch", "20", "--plot_epoch", "100"])
        config(args)
        got.append((args.test_epoch, args.plot_epoch))
    assert got[0] == got[1] == (min(20, epochs), min(100, epochs))


BLOCKED_RUN = r"""
import os, sys
sys.path.insert(0, %(repo)r)
for name in %(blocked)r:
    sys.modules[name] = None
import pkgutil, importlib
import vihds_tpu_torch
for mod in pkgutil.walk_packages(vihds_tpu_torch.__path__, "vihds_tpu_torch."):
    if mod.name != "vihds_tpu_torch.plotting":
        importlib.import_module(mod.name)
from vihds_tpu_torch import run_xval
argv = [%(spec)r, "--experiment", "off", "--epochs", "2", "--test_epoch", "1",
        "--train_samples", "4", "--test_samples", "4", "--seed", "0"]
run_xval.main(argv, device="cpu")
(run_dir,) = os.listdir(os.environ["INFERENCE_RESULTS_DIR"])
names = os.listdir(os.path.join(os.environ["INFERENCE_RESULTS_DIR"], run_dir))
print("xval files", len([n for n in names if n.startswith("xval_")]), "completed" in str(names))
os.environ["INFERENCE_RESULTS_DIR"] = os.path.join(os.environ["INFERENCE_RESULTS_DIR"], "fig")
try:
    run_xval.main(argv + ["--figures"], device="cpu")
except SystemExit as e:
    print("stopped:", e)
print("results for --figures:", os.path.exists(os.environ["INFERENCE_RESULTS_DIR"]))
"""


@pytest.mark.parametrize("blocked", [("matplotlib", "seaborn", "tensorboard"), ("tensorboard",)],
                         ids=["all-three", "tensorboard"])
def test_runs_without_the_plotting_packages(blocked, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["INFERENCE_RESULTS_DIR"] = str(tmp_path)
    code = BLOCKED_RUN % dict(repo=REPO, blocked=list(blocked), spec=spec("dr_constant_one.yaml"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines.count("TensorBoard summaries off: the tensorboard package is not installed") == 1
    assert "xval files 16 True" in lines
    assert "stopped: --figures needs the %s package, which is not installed" % blocked[0] in lines
    assert "results for --figures: False" in lines
    assert not any(line.startswith("Training:") for line in
                   lines[lines.index("xval files 16 True"):])


def test_no_module_of_the_port_imports_the_plotting_packages_when_it_loads():
    code = (
        "import sys, pkgutil, importlib; sys.path.insert(0, %r)\n"
        "import vihds_tpu_torch\n"
        "for mod in pkgutil.walk_packages(vihds_tpu_torch.__path__, 'vihds_tpu_torch.'):\n"
        "    if mod.name != 'vihds_tpu_torch.plotting':\n"
        "        importlib.import_module(mod.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('matplotlib', 'seaborn', 'tensorboard', 'tensorflow')\n"
        "             or m == 'torch.utils.tensorboard')\n"
        "assert not bad, bad\n"
        "print('clean')\n" % REPO
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "clean" in r.stdout
