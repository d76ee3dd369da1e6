"""Device kernels of the traced segment over its passes."""

from portbench import readers


def read(run):
    return readers.launches_per_unit(run, "eval")
