"""Device kernels of the traced segment over its batched steps."""

from portbench import readers


def read(run):
    return readers.launches_per_unit(run, "train")
