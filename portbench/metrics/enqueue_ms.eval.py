"""Host milliseconds a pass spends in ``VmapXval._evaluate`` before any
fetch, the mean over the window's passes."""


def read(run):
    if run.mode != "eval":
        return None
    return 1e3 * sum(run.pass_enqueue_s) / len(run.pass_enqueue_s)
