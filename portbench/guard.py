"""The check that no JAX is loaded: the port, and everything the benchmark
runs, import neither JAX nor the JAX package.  Modules are compared by
their top-level name, the part before the first dot, as a whole name:
``vihds_tpu_torch`` begins with ``vihds_tpu`` and is not it."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "vihds_tpu")


def forbidden_loaded(modules=None):
    """The forbidden top-level names among ``modules`` (default: every
    module loaded in this process), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
