"""The share of the traced evaluation segment with no kernel and no copy on
the device (%)."""

from portbench import readers


def read(run):
    return readers.idle_share(run, "eval")
