"""Training samples a second: fold x series x IWAE draw rows of every
batched step completed in the window, over the whole window."""

from portbench import readers


def read(run):
    return readers.rate(run, "train")
