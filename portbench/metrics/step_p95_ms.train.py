"""The 95th percentile of the program's own per-step intervals (the CUDA
events ``VmapXval.train_steps`` records) over the window."""

from portbench import counts


def read(run):
    if run.mode != "train":
        return None
    return counts.percentile(run.step_ms, 95)
