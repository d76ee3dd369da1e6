"""A run whose timed path is broken underneath comes out not correct: each
fault a cell can have, planted in the program, past the look for a card."""

import contextlib
import time

import pytest

from portbench import calibrate, harness
from portbench.tests.test_portbench_reference import SMALL


@contextlib.contextmanager
def state_unchanged():
    """Optimizer steps that return the params unchanged."""
    from vihds_tpu_torch import training

    original = training.Optimizer.step

    def step(self):
        self.count += 1

    training.Optimizer.step = step
    try:
        yield
    finally:
        training.Optimizer.step = original


@contextlib.contextmanager
def eval_patched(change):
    """``change(result, batch)`` applied to every evaluation chunk's
    outputs where ``eval_step`` produces them."""
    from vihds_tpu_torch import xfold

    original = xfold.eval_step

    def eval_step(model, program, params, batch, n_samples, **kw):
        res = original(model, program, params, batch, n_samples, **kw)
        change(res)
        return res

    xfold.eval_step = eval_step
    try:
        yield
    finally:
        xfold.eval_step = original


def _half_rows(res):
    """Half of the chunk's rows left out: their outputs are the other
    half's."""
    for v in res.values():
        n = v.shape[0] // 2
        v[n:2 * n] = v[:n].clone()


def _one_answer(res):
    """One series' served log evidence (its per-item ELBO) altered by 0.1 %."""
    res["per_item_elbo"][0] *= 1.001


FAULTS = [("bb_xval4_train_k1000", "state unchanged", state_unchanged),
          ("bb_xval4_train_k1000", "half the batch", calibrate.half_batch),
          ("dr_xval4_eval", "half the batch", lambda: eval_patched(_half_rows)),
          ("dr_xval4_eval", "one answer altered", lambda: eval_patched(_one_answer)),
          ("bb_xval4_eval", "half the batch", lambda: eval_patched(_half_rows)),
          ("bb_xval4_eval", "one answer altered", lambda: eval_patched(_one_answer))]


@pytest.mark.parametrize("cell,name,fault", FAULTS, ids=[f"{c}-{n}" for c, n, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, name, fault):
    with fault():
        result, lines = harness.run_cell(cell, 2147483659, 0.1, 0, time.perf_counter(),
                                         device="cpu", mix_overrides=SMALL[cell])
    assert not result["correct"], lines
