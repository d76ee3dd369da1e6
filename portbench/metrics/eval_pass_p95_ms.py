"""The 95th percentile over every pass of the window of a pass's wall, from
its call to its results on the host (the host clock around it)."""

from portbench import counts


def read(run):
    if run.mode != "eval":
        return None
    return counts.percentile(run.pass_ms, 95)
