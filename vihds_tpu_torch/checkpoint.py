"""Training-state checkpointing: params, Adam state, the training generator's
state and the epoch, one ``torch.save`` file per checkpointed epoch.

The counterpart of ``vihds_tpu.checkpoint`` (orbax there).  ``directory``
holds ``<epoch>.pt`` files; the newest three are kept.  A run resumed from
a checkpoint follows the uninterrupted run: the batch orders are a function
of (seed, epoch) alone (``training.epoch_perm``) and the latent draws
continue from the saved generator state.
"""

import os
import re

import torch

MAX_TO_KEEP = 3


def _epochs(directory):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(re.compile(r"^(\d+)\.pt$").match,
                                               os.listdir(directory)) if m)


def save(directory, epoch, state):
    """Write ``state`` (a dict of tensors, state dicts and ints) as the
    checkpoint of ``epoch``; drop all but the newest ``MAX_TO_KEEP``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "%d.pt" % epoch)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in _epochs(directory)[:-MAX_TO_KEEP]:
        os.remove(os.path.join(directory, "%d.pt" % old))


def latest_epoch(directory):
    epochs = _epochs(directory)
    return epochs[-1] if epochs else None


def restore(directory, epoch=None):
    """Load the checkpoint of ``epoch`` (default: the newest) with its
    tensors on the host.  Returns (epoch, state) or (None, None) when
    nothing is saved."""
    step = epoch if epoch is not None else latest_epoch(directory)
    if step is None:
        return None, None
    path = os.path.join(directory, "%d.pt" % step)
    return step, torch.load(path, map_location="cpu")
