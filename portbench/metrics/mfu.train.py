"""A training step's share of the float32 peak (%)."""

from portbench import readers


def read(run):
    return readers.mfu(run, "train")
