"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names."""

import os
import subprocess
import sys

from portbench import guard

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_top_level_names_are_compared_whole():
    assert guard.forbidden_loaded(["vihds_tpu_torch", "vihds_tpu_torch.xfold", "jaxtyping",
                                   "flaxen", "torch"]) == []
    assert guard.forbidden_loaded(["vihds_tpu.training", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "vihds_tpu"]


def test_the_harness_and_the_program_it_drives_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import run, harness, calibrate, check, drive, readers\n"
            "import vihds_tpu_torch.xfold, vihds_tpu_torch.profiling\n"
            "import vihds_tpu_torch.ops.fused_blackbox, vihds_tpu_torch.ops.fused_ode\n"
            "from portbench import guard; print(guard.forbidden_loaded())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
