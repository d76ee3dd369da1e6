"""Map a JAX param tree (``vihds_tpu.vae.VAE.init_params`` or a trained
one, as numpy arrays) onto the port's params.

The port keeps the JAX layouts, so the map is leaf for leaf:

* linear weights stay ``[n_in, n_out]`` and are applied as ``x @ w`` (not
  ``nn.Linear``'s ``[out, in]``); biases ``[n_out]``;
* the conv weight stays ``[n_filters, n_in_channels, filter_size]``, which
  is already PyTorch's OIH layout for ``F.conv1d``;
* the global q-site free parameters ``glob_mu`` / ``glob_lp`` stay vectors.

Every leaf becomes a float32 tensor on ``device``.  This module imports no
JAX: callers hand it numpy arrays (``jax.tree_util.tree_map(np.asarray, p)``
or any array convertible by ``np.asarray``).
"""

import numpy as np
import torch

from vihds_tpu_torch.utils import resolve_device


def params_from_jax(tree, device="cuda"):
    """Nested dict of arrays -> nested dict of float32 tensors on ``device``."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=device)
