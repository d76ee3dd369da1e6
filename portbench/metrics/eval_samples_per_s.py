"""Evaluation samples a second: held-out series x IWAE draws of every pass
completed in the window (padding rows not counted), over the whole
window."""

from portbench import readers


def read(run):
    return readers.rate(run, "eval")
