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

A flat file carries a tree under key paths of the form
``dec['precisions']['degr']['b']`` (``jax.tree_util.keystr`` of each leaf's
path after a prefix, as the simulator's truth npz writes its decoder
params): ``params_from_keystr`` reads such keys back into a nested dict and
``keystr_leaves`` writes them, letter for letter.
"""

import re

import numpy as np
import torch

from vihds_tpu_torch.utils import resolve_device


def params_from_jax(tree, device="cuda"):
    """Nested dict of arrays -> nested dict of float32 tensors on ``device``."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=device)


_KEY = re.compile(r"\['([^']*)'\]")


def params_from_keystr(flat, prefix="dec", device="cuda"):
    """The leaves of ``flat`` (a mapping, e.g. an ``np.load`` of a truth
    npz) whose keys are ``prefix`` followed by ``['a']['b']...`` -> nested
    dict of float32 tensors on ``device``; other keys are ignored."""
    device = resolve_device(device)
    tree = {}
    for key in flat.keys():
        if not key.startswith(prefix + "['"):
            continue
        names = _KEY.findall(key[len(prefix):])
        node = tree
        for name in names[:-1]:
            node = node.setdefault(name, {})
        node[names[-1]] = torch.as_tensor(np.array(flat[key], dtype=np.float32), device=device)
    return tree


def keystr_leaves(tree, prefix="dec"):
    """Nested dict of tensors or arrays -> {``prefix['a']['b']``: numpy
    array}, in the order ``jax.tree_util`` flattens a dict (sorted keys)."""
    out = {}
    for name in sorted(tree):
        key = "%s['%s']" % (prefix, name)
        leaf = tree[name]
        if isinstance(leaf, dict):
            out.update(keystr_leaves(leaf, key))
        else:
            out[key] = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
    return out
