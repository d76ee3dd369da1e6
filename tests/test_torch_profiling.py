"""The port's profiling hooks on the CPU: ``run_xval --profile_dir`` writes
exactly one ``torch.profiler`` trace, of the first epoch chunk after the
start epoch (the rule of the JAX package's ``Training.run``), also after a
resume; ``profiling.trace`` is a no-op without a directory; ``StepTimer``
reports the JAX package's summary keys; ``enable_compile_cache`` returns
None, as the JAX package's does off a TPU."""

import json
import os

import pytest
import torch

from tests.conftest import spec
from vihds_tpu.profiling import StepTimer as JStepTimer
from vihds_tpu_torch import profiling, run_xval
from vihds_tpu_torch.config import Config, Trainer

ARGV = [spec("dr_constant_one.yaml"), "--test_epoch", "1", "--train_samples", "4",
        "--test_samples", "4", "--seed", "0", "--plot_epoch", "0"]


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_profile_dir_traces_the_first_chunk_after_the_start_epoch(tmp_results):
    profile_dir = tmp_results / "profile"
    run_xval.main(ARGV + ["--experiment", "prof", "--epochs", "3", "--profile_dir",
                          str(profile_dir)], device="cpu")
    assert os.listdir(profile_dir) == ["epochs_2-2.json"]
    names = {e.get("name", "") for e in _trace_events(profile_dir / "epochs_2-2.json")}
    # the traced chunk ran optimizer steps: the autograd engine and Adam
    assert any(n.startswith("aten::") for n in names)
    assert any("Optimizer.step" in n for n in names)


def test_profile_dir_after_a_resume(tmp_results):
    """Resumed at epoch 2 (a checkpoint of epoch 1), the first chunk is
    epoch 2 and the trace is of epoch 3."""
    first = ARGV + ["--experiment", "first", "--epochs", "1", "--checkpoint_epoch", "1"]
    args = run_xval.create_parser(True).parse_args(first)
    settings = Config(args)
    settings.trainer = Trainer(args, log_dir=str(tmp_results / "first"))
    training = run_xval.run_on_split(args, settings, device="cpu")[2]
    profile_dir = tmp_results / "profile"
    run_xval.main(ARGV + ["--experiment", "resumed", "--epochs", "3", "--resume_from",
                          training.ckpt_dir, "--profile_dir", str(profile_dir)], device="cpu")
    assert os.listdir(profile_dir) == ["epochs_3-3.json"]


def test_trace_without_a_directory_is_a_no_op(tmp_path):
    with profiling.trace(None) as prof:
        torch.ones(3).sum()
    assert prof is None
    with profiling.trace(str(tmp_path / "p"), "block") as prof:
        torch.ones(3).sum()
    assert prof is not None and os.listdir(tmp_path / "p") == ["block.json"]


@pytest.mark.parametrize("n", [0, 3])
def test_step_timer_reports_the_jax_packages_keys(n):
    timer, jtimer = profiling.StepTimer(), JStepTimer()
    for _ in range(n):
        with timer.measure(torch.ones(2)):
            pass
        with jtimer.measure():
            pass
    assert sorted(timer.summary()) == sorted(jtimer.summary())
    assert len(timer.times) == n and (n == 0 or timer.summary()["n"] == n)


def test_enable_compile_cache_is_none():
    assert profiling.enable_compile_cache() is None
    assert profiling.enable_compile_cache("/nonexistent", force=True) is None


def test_profile_dir_says_when_no_chunk_is_traced(tmp_results, capsys):
    """``--epochs 2 --test_epoch 10``: the only chunk starts at the start
    epoch, so no trace is written (as in the JAX package) and the run says
    so in one line; the run's artifacts are written as without the flag."""
    profile_dir = tmp_results / "profile"
    run_xval.main(ARGV + ["--experiment", "untraced", "--epochs", "2", "--test_epoch", "10",
                          "--profile_dir", str(profile_dir)], device="cpu")
    lines = [line for line in capsys.readouterr().out.splitlines() if "--profile_dir" in line]
    assert lines == ["--profile_dir %s: no chunk traced: the trace is of the first chunk after "
                     "the start epoch 1, and epochs 1-2 ran as one chunk (a --test_epoch or "
                     "--checkpoint_epoch below --epochs ends a chunk)" % profile_dir]
    assert not profile_dir.exists()
    (run,) = [d for d in os.listdir(tmp_results) if d.startswith("untraced")]
    assert "completed.txt" in os.listdir(tmp_results / run)
