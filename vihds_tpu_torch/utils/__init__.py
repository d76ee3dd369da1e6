"""Small shared utilities: attr-dicts, spec lookups and device selection."""

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
