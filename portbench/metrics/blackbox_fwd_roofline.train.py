"""``blackbox_fwd``'s share of its roofline in a training step (%)."""

from portbench import readers


def read(run):
    return readers.roofline(run, "blackbox_fwd", "train")
