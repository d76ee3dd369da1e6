"""Profiling hooks: a ``torch.profiler`` trace behind ``--profile_dir`` and
a timer of steps.

``trace(profile_dir)`` records the enclosed block with ``torch.profiler``
(CPU activity, and CUDA activity where a card is visible) and writes one
Chrome trace, ``<profile_dir>/<name>.json``, viewable in Perfetto or
``chrome://tracing``.  ``Training.run`` wraps the first chunk of epochs after
the start epoch in it, as ``vihds_tpu.training`` does with its device trace;
under ``--vmap_folds`` ``xfold.VmapXval.run`` wraps its first batched chunk
after the start epoch, every fold in the one trace.
"""

import contextlib
import os
import time

import numpy as np
import torch


def enable_compile_cache(cache_dir=None, force=False):
    """The JAX package's switch for its persistent XLA compilation cache.

    The port compiles no XLA program, so there is nothing to cache here and
    this returns None, as the JAX version does off a TPU.  The port's own
    compiled code is its CUDA kernels, which ``vihds_tpu_torch.ops.build``
    already caches on disk (``build/kernels/lib<name>_<hash>.so``, the hash
    over the sources and flags)."""
    return None


@contextlib.contextmanager
def trace(profile_dir, name="trace"):
    """Profile the enclosed block into ``<profile_dir>/<name>.json`` (a
    no-op when ``profile_dir`` is empty).  Yields the profiler, or None."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            # the block's kernels end inside the trace
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(profile_dir, name + ".json"))


class StepTimer:
    """Wall-clock timing of steps; ``measure(result)`` waits for the card to
    finish its queued work before it stops the clock, where the JAX version
    blocks on ``result`` (use sparingly: it stalls the host until the card
    has caught up)."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self, result_to_block_on=None):
        t0 = time.perf_counter()
        yield
        if result_to_block_on is not None and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)

    def summary(self):
        t = np.asarray(self.times)
        if t.size == 0:
            return {}
        return {
            "n": int(t.size),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
        }
