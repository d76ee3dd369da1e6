"""The control, the reference in float32 with TF32 matrix products put in
the program's place, comes out not correct (on the card: TF32 is the card's
arithmetic).  At a small K; ``portbench/calibrate.py`` reads it at each
cell's own size."""

import time

import pytest
import torch

from portbench import check, harness, manifest

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 is the card's arithmetic")
    return "cuda"


@pytest.mark.parametrize("cell,small", [("bb_xval4_train_k1000", {"samples": 50, "chunk_epochs": 1}),
                                        ("dr_xval4_eval", {"samples": 100, "warm_passes": 1}),
                                        ("bb_xval4_eval", {"samples": 100, "warm_passes": 1})])
def test_the_control_is_not_correct(cuda, cell, small):
    result, _ = harness.run_cell(cell, 2147483659, 0.5, 0, time.perf_counter(), device=cuda,
                                 mix_overrides=small, control=True)
    limits = manifest.cell(manifest.load(), cell)["limits"]
    assert result["correct"]
    assert not check.judge(result["control"], limits)[0], result["control"]
