"""The harness fails, rather than falling back to the CPU, where no card is
visible, and where the checkout holds only the benchmark."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARGS = ["--workload", "bb_xval4_eval", "--seed", "2147483659", "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py"] + ARGS, capture_output=True,
                          text=True, timeout=300, cwd=cwd, env=env)


def test_no_card_exits_non_zero_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_a_checkout_of_the_benchmark_alone_exits_non_zero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
