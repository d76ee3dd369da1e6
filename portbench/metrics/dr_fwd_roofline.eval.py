"""``dr_fwd``'s share of its roofline in an evaluation pass (%)."""

from portbench import readers


def read(run):
    return readers.roofline(run, "dr_fwd", "eval")
