"""Small shared utilities: attr-dicts, spec lookups, device selection and
the optional TensorBoard / figure outputs."""

import importlib

import numpy as np
import torch

from vihds_tpu_torch.utils.attrdict import AttrDict, attrdictify  # noqa: F401


def default_get_value(dct, key, default_value, verbose=False):
    if key in dct:
        return dct[key]
    if verbose:
        print("%s using default %s" % (key, str(default_value)))
    return default_value


def resolve_device(device="cuda"):
    """The ``torch.device`` an entry point runs on.

    ``"cuda"`` (every entry point's default) raises when no card is visible:
    the port never falls back to the CPU unless the caller asks for it with
    ``device="cpu"``, as the tests do."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        # Pin float32 on the card.  cuDNN runs float32 convolutions in TF32 by
        # default (about three decimal digits), which would move the encoder
        # conv away from the float32 XLA conv of the JAX reference; matmuls
        # stay in full float32 as well.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return dev


#: the lines ``note_once`` has printed in this process
_NOTED = set()


def note_once(line):
    """Print ``line`` the first time it comes in this process."""
    if line not in _NOTED:
        _NOTED.add(line)
        print(line, flush=True)


def missing_packages(names):
    """The packages of ``names`` that cannot be imported, in order."""
    missing = []
    for name in names:
        try:
            importlib.import_module(name)
        except ImportError:
            missing.append(name)
    return missing


#: what the figures need: matplotlib and seaborn render them, tensorboard
#: carries them into the event files
FIGURE_PACKAGES = ("matplotlib", "seaborn", "tensorboard")


def summary_writer(path):
    """A ``torch.utils.tensorboard.SummaryWriter`` writing under ``path``,
    or None where the tensorboard package cannot be imported (said once per
    process).  The summaries are an optional output: a run without them
    writes its ``xval_*`` set, cache and checkpoints all the same."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        note_once("TensorBoard summaries off: the tensorboard package is not installed")
        return None
    return SummaryWriter(path)


def variable_summaries(writer, epoch, var, name, plot_histograms=False):
    """TensorBoard mean / stddev / max / min scalars (and, with
    ``plot_histograms``, a histogram) of the numpy array ``var``."""
    if writer is None:
        return
    var = np.asarray(var)
    mean = var.mean()
    writer.add_scalar(name + "/mean", mean, epoch)
    writer.add_scalar(name + "/stddev", float(np.sqrt(((var - mean) ** 2).mean())), epoch)
    writer.add_scalar(name + "/max", var.max(), epoch)
    writer.add_scalar(name + "/min", var.min(), epoch)
    if plot_histograms:
        writer.add_histogram(name + "/histogram", var, epoch)
