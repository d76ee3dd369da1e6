"""Set-up: process start to the first timed step or pass (loading,
kernels built or loaded, warm-up)."""


def read(run):
    return run.setup_s
