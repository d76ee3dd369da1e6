"""The frozen reference against the port's plain path on the CPU: each
cell's run at a small K, its numbers within the cell's limits."""

import time

import pytest

from portbench import harness

SMALL = {"bb_xval4_train_k1000": {"samples": 2, "chunk_epochs": 1},
         "dr_xval4_eval": {"samples": 3, "warm_passes": 1},
         "bb_xval4_eval": {"samples": 2, "warm_passes": 1}}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_reference_holds_the_port_s_plain_path(cell):
    result, lines = harness.run_cell(cell, 2147483659, 0.1, 0, time.perf_counter(),
                                     device="cpu", mix_overrides=SMALL[cell])
    assert result["correct"], lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "check"
