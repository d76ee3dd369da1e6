"""Host milliseconds a step spends issuing work: the host clock around each
chunk's ``train_steps`` call, before its one read, over the chunk's steps,
for the whole window."""


def read(run):
    if run.mode != "train":
        return None
    return 1e3 * sum(run.chunk_enqueue_s) / sum(run.chunk_steps)
