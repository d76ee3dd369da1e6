"""Training-state checkpointing: params, Adam state, the training generator's
state and the epoch, one ``torch.save`` file per checkpointed epoch.

The counterpart of ``vihds_tpu.checkpoint`` (orbax there).  ``directory``
holds ``<epoch>.pt`` files; the newest three are kept.  A run resumed from
a checkpoint follows the uninterrupted run: the batch orders are a function
of (seed, epoch) alone (``training.epoch_perm``) and the latent draws
continue from the saved generator state.  ``call_run_xval --vmap_folds``
saves its stacked state here too, in ``checkpoints_vmap/``: params and Adam
moments with their fold axis, the generator, the epoch and the per-fold
``alive`` mask (``xfold.VmapXval``).  Over several processes rank 0 writes
and every rank waits for it at a barrier; every rank restores the same file.
"""

import os
import re

import torch

from vihds_tpu_torch.parallel import multihost

MAX_TO_KEEP = 3


def _epochs(directory):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(re.compile(r"^(\d+)\.pt$").match,
                                               os.listdir(directory)) if m)


def save(directory, epoch, state):
    """Write ``state`` (a dict of tensors, state dicts and ints) as the
    checkpoint of ``epoch``; drop all but the newest ``MAX_TO_KEEP``.  Over
    several processes, rank 0's call writes and every call returns once it
    has."""
    if multihost.is_main():
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "%d.pt" % epoch)
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in _epochs(directory)[:-MAX_TO_KEEP]:
            os.remove(os.path.join(directory, "%d.pt" % old))
    multihost.barrier()


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
